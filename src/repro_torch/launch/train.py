"""Training launcher — port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --steps 100 [--reduced] [--mesh host|single|multi] \
        [--device cuda|cpu] [--seq-shard-attn] [--ckpt-dir DIR]

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node N -m repro_torch.launch.train --mesh host ...

Wires together: arch config -> mesh -> train state placed by the
sharding rules -> deterministic data pipeline -> the eager train step
(in-place AdamW) -> atomic checkpoints -> straggler watchdog -> elastic
restart (restore onto whatever mesh this launch has).

One process runs per mesh position.  Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` set) the launcher joins a process group
and places the state as ``DTensor``s over a ``("data", "model")``
``DeviceMesh``; every process draws the same global batch and keeps its
rows.  ``--mesh host`` is ``(world_size, 1)``; ``single`` and ``multi``
are the reference's 256- and 512-device meshes and raise unless that
many processes run.  The device rule: ``cuda:LOCAL_RANK % device_count``
(raising without a card) unless ``--device cpu``; the group's backend is
``nccl`` where every process on the host has a card of its own, else
``gloo`` (ranks that share a card, which NCCL refuses, or the CPU).  One
process without ``torchrun`` runs on ``--device`` with plain tensors.
``main`` returns the final state and one record per step run (step,
loss, grad_norm, seconds).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import checkpoint, elastic, sharding, straggler
from repro_torch.launch.mesh import device_mesh, get_mesh, init_process
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import step as train_step_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU runs)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard-attn", action="store_true",
                    help="sequence-sharded attention over the mesh")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev, backend = init_process(args.device)
    mesh = get_mesh(args.mesh)
    dmesh = device_mesh(mesh, dev.type)
    if args.seq_shard_attn and not cfg.is_attention_free:
        dp = sharding.dp_axes(mesh)
        cfg = dataclasses.replace(
            cfg, attn_seq_shard=dp if isinstance(dp, tuple) else (dp,))
    rank = torch.distributed.get_rank() if dmesh is not None else 0

    ocfg = opt.OptConfig(peak_lr=args.lr, total_steps=max(args.steps, 100))
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)

    state = train_step_mod.init_state(0, cfg, device=dev, device_mesh=dmesh)
    start = 0
    if args.ckpt_dir:
        step0, restored = elastic.resume_elastic(
            args.ckpt_dir, state, mesh, run_dir=args.ckpt_dir)
        if restored is not None:
            if dmesh is not None:
                restored = sharding.place(restored, train_step_mod.state_specs(
                    restored, dmesh), dmesh)
            state, start = restored, step0
            if rank == 0:
                print(f"[launch] elastic restore at step {start} onto "
                      f"{mesh.size} device{'s' * (mesh.size > 1)} ({dev})")

    step_fn = train_step_mod.make_train_step(cfg, ocfg, args.microbatches)
    watchdog = straggler.StragglerWatchdog()

    n = transformer.param_count(state["params"])
    axes = dict(zip(mesh.axis_names, mesh.shape))
    where = (f"rank {rank} on {dev}, {backend}" if dmesh is not None
             else f"{dev}")
    print(f"[launch] {cfg.name} ({n/1e6:.1f}M params) on {mesh.size} "
          f"device{'s' * (mesh.size > 1)} {axes} ({where})")
    history = []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = pipeline.batch_at(dcfg, step)
        if dmesh is not None:      # every process keeps its own rows
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            batch = sharding.place(batch, sharding.batch_specs(batch, dmesh),
                                   dmesh)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        dt = time.time() - t0
        history.append({"step": step, "loss": loss, "seconds": dt,
                        "grad_norm": float(metrics["grad_norm"])})
        act = watchdog.observe(dt)
        if act != straggler.OK and rank == 0:
            print(f"[watchdog] step {step}: {act}")
        if (step % 5 == 0 or step == args.steps - 1) and rank == 0:
            print(f"[launch] step {step:4d} loss {loss:8.4f} {dt:5.1f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
    if rank == 0:
        print("[launch] done")
    return state, history


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
