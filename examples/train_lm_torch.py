"""End-to-end training script on the PyTorch port: a yi-family dense LM on
the synthetic pipeline, with checkpoint/restart, straggler watchdog and
loss logging (the port's counterpart of ``examples/train_lm.py``).

Quick smoke on a CPU:

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30

The ~100M-parameter run on a CUDA card (the default device):

    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300

Kill it at any point and rerun the same command — it restarts from the
latest published checkpoint (atomic-rename publish; see
repro_torch/dist/checkpoint.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint, straggler
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import step as train_step_mod

PRESETS = {
    # ~10M: CI-sized smoke model (yi topology, tiny dims).
    "10m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_head=64,
                d_ff=704, vocab_size=8192),
    # ~100M-parameter dense LM.
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_head=64, d_ff=2048, vocab_size=32_000),
}


def build_config(preset: str) -> ArchConfig:
    base = configs.get_arch("yi-9b")
    return dataclasses.replace(base, name=f"yi-{preset}", **PRESETS[preset])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_config(args.preset)
    ocfg = opt.OptConfig(peak_lr=args.lr, warmup_steps=20,
                         total_steps=max(args.steps, 100))
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=0)

    state = train_step_mod.init_state(0, cfg, device=dev)
    n_params = transformer.param_count(state["params"])
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step, {args.steps} steps on {dev}")

    start_step, restored = checkpoint.restore_latest(
        f"{args.ckpt_dir}/{args.preset}", state)
    if restored is not None:
        state = restored
        print(f"[train] restored checkpoint at step {start_step}")

    step_fn = train_step_mod.make_train_step(cfg, ocfg)
    watchdog = straggler.StragglerWatchdog()

    tokens_per_step = args.batch * args.seq
    first_loss = loss = None
    for step in range(start_step, args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, pipeline.batch_at(dcfg, step))
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if first_loss is None:
            first_loss = loss
        action = watchdog.observe(dt)
        if action != straggler.OK:
            print(f"[watchdog] step {step}: {dt:.1f}s -> {action}")
        if step % args.log_every == 0 or step == args.steps - 1:
            mfu_flops = 6 * n_params * tokens_per_step / dt
            print(f"[train] step {step:4d} loss {loss:7.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):6.2f} "
                  f"{dt:5.2f}s/step {mfu_flops / 1e9:6.1f} GFLOP/s")
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            d = checkpoint.save(f"{args.ckpt_dir}/{args.preset}", step + 1,
                                state)
            print(f"[ckpt]  published {d}")
    if first_loss is None:
        print(f"[train] nothing to do: step {start_step} >= --steps "
              f"{args.steps}")
        return None, None
    print(f"[train] done: loss {first_loss:.4f} -> {loss:.4f} "
          f"({'DOWN' if loss < first_loss else 'not down'})")
    return first_loss, loss


if __name__ == "__main__":
    main()
