"""Training launcher — port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --steps 100 [--reduced] [--device cuda|cpu] [--ckpt-dir DIR]

Wires together: arch config -> train state on ``--device`` ->
deterministic data pipeline -> the eager train step (in-place AdamW) ->
atomic checkpoints -> straggler watchdog -> elastic restart (restore onto
this launch's device).  ``--device`` (default ``cuda``, raising without a
card) takes the place of the reference's ``--mesh``: one device, no
sharding.  On a CPU use ``--reduced --device cpu``.  ``main`` returns
the final state and one record per step run (step, loss, grad_norm,
seconds).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint, elastic, straggler
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import step as train_step_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard-attn", action="store_true",
                    help="sequence-sharded attention (multi-device only)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    if args.seq_shard_attn:
        raise NotImplementedError(
            "--seq-shard-attn shards attention over a device mesh; the "
            "port runs on one device until multi-device support lands "
            "(ROADMAP Queue 1 item 7)")
    dev = resolve_device(args.device)
    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    ocfg = opt.OptConfig(peak_lr=args.lr, total_steps=max(args.steps, 100))
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)

    state = train_step_mod.init_state(0, cfg, device=dev)
    start = 0
    if args.ckpt_dir:
        step0, restored = elastic.resume_elastic(
            args.ckpt_dir, state, dev, run_dir=args.ckpt_dir)
        if restored is not None:
            state, start = restored, step0
            print(f"[launch] elastic restore at step {start} onto 1 "
                  f"device ({dev})")

    step_fn = train_step_mod.make_train_step(cfg, ocfg, args.microbatches)
    watchdog = straggler.StragglerWatchdog()

    n = transformer.param_count(state["params"])
    print(f"[launch] {cfg.name} ({n/1e6:.1f}M params) on {dev}")
    history = []
    for step in range(start, args.steps):
        t0 = time.time()
        state, metrics = step_fn(state, pipeline.batch_at(dcfg, step))
        loss = float(metrics["loss"])           # waits for the step
        dt = time.time() - t0
        history.append({"step": step, "loss": loss, "seconds": dt,
                        "grad_norm": float(metrics["grad_norm"])})
        act = watchdog.observe(dt)
        if act != straggler.OK:
            print(f"[watchdog] step {step}: {act}")
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[launch] step {step:4d} loss {loss:8.4f} {dt:5.1f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
    print("[launch] done")
    return state, history


if __name__ == "__main__":
    main()
