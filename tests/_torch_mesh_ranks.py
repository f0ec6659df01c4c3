"""One rank of the port's training over a (2, 2) ("data", "model") mesh
of four gloo processes on the CPU (helper of
tests/test_torch_mesh_train.py; not collected; imports no JAX).

    PYTHONPATH=src python tests/_torch_mesh_ranks.py RANK PORT WORKDIR

``WORKDIR/init.npz`` holds each arch's initial state (``{arch}/{leaf
path}``, the reference's ``init_state`` as numpy) and ``WORKDIR/ckpt_one``
a checkpoint of yi-9b's written by one process.  The rank places each
state by ``state_specs`` (its blocks as ``{arch}/block/...``), runs one
step of every case of ``_ref_train_mesh_dump.CASES`` from the placed
initial state (metrics as ``{case}/metric/...``; rank 0 also the gathered
state as ``{case}/after/...``), each under :func:`step_collectives`,
whose guard records every functional all-gather of the step (forward,
recomputation, backward and AdamW; ``{case}/functional_gathers``), and
the ``yi`` step's collectives by kind as ``collectives/count`` and
``collectives/bytes``; saves the placed state after the ``yi``
step to ``WORKDIR/ckpt_mesh`` with every rank, restores ``ckpt_one`` and
places it (``restored/block/...``), resumes ``ckpt_mesh`` elastically
(``WORKDIR/scale_events.jsonl``), and runs the int8-compressed sum over
the data axis of a (4, 1) mesh (``psum/...``).  It writes
``WORKDIR/rank{RANK}.npz``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _ref_train_mesh_dump as ref  # noqa: E402  (numpy only)

WORLD = 4


def tree_of(flat: dict, prefix: str) -> dict:
    """``{"a/b": x}`` under ``prefix/`` as the nested dict ``{"a": {"b":
    x}}``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *head, last = key[len(prefix) + 1:].split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def step_collectives(step, state, batch) -> tuple:
    """``step(state, batch)`` under a recording
    ``analysis.NoFunctionalGather`` (a ``CollectiveCounter``): its
    result, the collectives it issued on this process as (count, output
    bytes) arrays in the order of ``analysis.COLLECTIVES``, and how many
    of them were DTensor's functional all-gathers."""
    from repro_torch.roofline.analysis import COLLECTIVES, NoFunctionalGather
    with NoFunctionalGather(raises=False) as counter:
        result = step(state, batch)
    return result, (np.array([counter.counts[k] for k in COLLECTIVES]),
                    np.array([counter.nbytes[k] for k in COLLECTIVES])), \
        counter.fired


def main(rank: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.dist import checkpoint, compression, elastic, sharding
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.pytree import tree_paths
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    mesh = Mesh(("data", "model"), (2, 2))
    dm = device_mesh(mesh, "cpu")
    init = dict(np.load(os.path.join(workdir, "init.npz")))
    out = {}

    def cfg_of(arch, seq_shard=False):
        import dataclasses
        cfg = configs.get_arch(arch).reduced()
        if seq_shard:
            cfg = dataclasses.replace(cfg, attn_seq_shard=("data",))
        return cfg

    def placed(arch):
        st = step_mod.state_from_numpy(tree_of(init, arch), cfg_of(arch),
                                       device="cpu")
        return sharding.place(st, step_mod.state_specs(st, dm), dm)

    def dump(prefix, tree, fn):
        for path, leaf in tree_paths(tree):
            out[f"{prefix}/{'/'.join(path)}"] = fn(leaf).numpy()

    for arch in ref.ARCHS:
        dump(f"{arch}/block", placed(arch), lambda x: x.to_local())
    after_yi = None
    for name, (arch, seq_shard, mb) in ref.CASES.items():
        cfg = cfg_of(arch, seq_shard)
        batch = {k: torch.from_numpy(v) for k, v in
                 ref.case_batch(pipeline, name, cfg.vocab_size).items()}
        batch = sharding.place(batch, sharding.batch_specs(batch, dm), dm)
        step = step_mod.make_train_step(cfg, opt.OptConfig(), mb)
        (state, metrics), (count, nbytes), fired = step_collectives(
            step, placed(arch), batch)
        out[f"{name}/functional_gathers"] = np.asarray(fired)
        if name == "yi":
            out["collectives/count"], out["collectives/bytes"] = count, nbytes
        for k, v in metrics.items():
            out[f"{name}/metric/{k}"] = v.numpy()
        full = sharding.gather(state)         # every rank joins
        if rank == 0:
            dump(f"{name}/after", full, lambda x: x)
        if name == "yi":
            after_yi = state

    ckpt_mesh = os.path.join(workdir, "ckpt_mesh")
    checkpoint.save(ckpt_mesh, 1, after_yi)
    template = placed("yi-9b")
    _, restored = checkpoint.restore_latest(
        os.path.join(workdir, "ckpt_one"), template)
    restored = sharding.place(restored, step_mod.state_specs(restored, dm),
                              dm)
    dump("restored/block", restored, lambda x: x.to_local())
    step, _ = elastic.resume_elastic(ckpt_mesh, template, mesh,
                                     run_dir=workdir)
    out["elastic/step"] = np.asarray(step)

    flat = device_mesh(Mesh(("data", "model"), (WORLD, 1)), "cpu")
    g = torch.from_numpy(ref.psum_input()[rank])
    r = torch.zeros_like(g)
    for i in range(ref.PSUM_ROUNDS):
        total, r = compression.compressed_psum_leaf(
            g, r, flat.get_group("data"))
        out[f"psum/{i}/sum"] = total.numpy()
        out[f"psum/{i}/residual"] = r.numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
