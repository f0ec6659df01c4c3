"""Ranks of the port's model parallelism on the CPU: gloo processes over a
("data", "model") mesh whose ``model`` axis splits the weights (helper of
tests/test_torch_mesh_model_parallel.py and tests/test_torch_sharding.py;
not collected; imports no JAX).

    PYTHONPATH=src python tests/_torch_mesh_mp_ranks.py serve RANK PORT WORKDIR
    PYTHONPATH=src python tests/_torch_mesh_mp_ranks.py gather RANK PORT WORKDIR

``serve`` (:data:`SERVE_WORLD` processes, a ``(1, 2)`` mesh): for each
arch of :data:`CASES` the rank places ``WORKDIR/params.npz`` (the
reference's parameters, as ``_torch_mesh_serve_ranks.py`` reads them) by
``param_specs`` and serves ``_torch_mesh_serve_ranks.requests`` through
``build_model_fns`` and ``run_request_loop`` over ``MeshLookups``, all
under :class:`NoFunctionalGather`, which raises on DTensor's functional
all-gather; it records each batch (``{arch}/rec{i}/...``), the loop's
raw all-gathers (``{arch}/gathers``: count, bytes), and for the SSM
archs one decode step's after a prefill of the first batch
(``{arch}/step_gathers``).  Last, the guard on a plain DTensor
``Shard`` -> ``Replicate`` (``guard/fired``: what it raised) and the same
redistribution by ``sharding.redistribute`` (``guard/raw``).

``gather`` (:data:`GATHER_WORLD` processes, a ``(2, 2)`` mesh): for each
case of :data:`GATHER_CASES`, a seeded tensor placed by the case's
placements (a ``Partial`` block is the rank's own draw), gathered whole
by ``sharding.full``, with one tensor dimension by
``sharding.replicate_dim`` and moved to other placements by
``sharding.redistribute``, each beside DTensor's own redistribution of
the same tensor; and the gradient of a seeded weighted sum through each
beside DTensor's (``{case}/...``); for each case of :data:`ROW_CASES` the
row-parallel product ``layers.row_parallel`` beside the product of the
operands DTensor made whole, with both operands' gradients
(``row/{case}/...``).
Each raw run is under a recording :class:`NoFunctionalGather`
(``.../raw_functional``: the functional all-gathers it met).  Output:
``WORKDIR/{mode}{RANK}.npz``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from repro_torch.roofline.analysis import FunctionalGather, NoFunctionalGather

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_serve_ranks as serve_ranks  # noqa: E402  (torch only)

SERVE_WORLD, SERVE_SHAPE = 2, (1, 2)
#: arch -> resume, as ``_torch_mesh_serve_ranks.CASES``
CASES = {"yi-9b": True, "falcon-mamba-7b": False, "zamba2-2.7b": False}
GATHER_WORLD, GATHER_SHAPE = 4, (2, 2)
#: case -> (placements over the (2, 2) mesh, the dimension
#: ``replicate_dim`` gathers, the placements ``redistribute`` moves to),
#: of a (4, 8, 6) float32 tensor
GATHER_CASES = {
    "shard0_shard1": (("S0", "S1"), 1, ("S0", "R")),
    "shard1_shard1": (("S1", "S1"), 1, ("R", "S2")),
    "shard2_replicate": (("S2", "R"), 2, ("R", "S0")),
    "partial_shard0": (("P", "S0"), 0, ("R", "R")),
    "shard2_partial": (("S2", "P"), 2, ("S1", "R")),
    "partial_partial": (("P", "P"), 0, ("R", "R")),
    # new splits (Replicate -> Shard) and moved ones (Shard(a) -> Shard(b)),
    # by the raw cut: DTensor's backward of these gathers
    "replicate_shard": (("R", "R"), 1, ("S1", "S2")),
    "shard_to_shard": (("S0", "S1"), 0, ("S1", "S0")),
    "shard_outside": (("R", "S0"), 0, ("S0", "S0")),
    "partial_to_shard": (("P", "S1"), 1, ("S2", "S0")),
}
#: case -> (x's shape and placements, w's placements, the contraction's
#: first dimension): ``layers.row_parallel(x, w)`` against the product of
#: the operands made whole by DTensor (``full_tensor``; its own product
#: refuses a split sequence on some versions), w (6, 5)
ROW_CASES = {
    "rows_columns": ((4, 8, 6), ("S0", "S2"), ("R", "S0"), 2),
    "heads": ((4, 8, 2, 3), ("S0", "S2"), ("R", "S0"), 2),
    "split_sequence": ((4, 8, 2, 3), ("S0", "S1"), ("R", "S0"), 2),
    "whole_x": ((4, 8, 6), ("R", "R"), ("R", "S0"), 2),
}


def placement(code: str):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"R": Replicate(), "P": Partial()}.get(code) or Shard(int(code[1]))


def join(rank: int, port: int, world: int, shape) -> object:
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    return device_mesh(Mesh(("data", "model"), shape), "cpu")


def serve(rank: int, port: int, workdir: str) -> dict:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer
    from repro_torch.serve.admit_queue import AdmitQueue
    from repro_torch.serve.kv_index import (KVIndexConfig, KVSlabStore,
                                            MonarchKVIndex)
    from repro_torch.serve.step import greedy

    dm = join(rank, port, SERVE_WORLD, SERVE_SHAPE)
    flat = dict(np.load(os.path.join(workdir, "params.npz")))
    out = {}
    for arch, resume in CASES.items():
        cfg = configs.get_arch(arch).reduced()
        params = serve_ranks.placed(flat, arch, dm)
        idx = MonarchKVIndex(KVIndexConfig(**serve_ranks.kv_config(resume)),
                             device="cpu",
                             slab_store=KVSlabStore() if resume else None)
        queue = AdmitQueue(idx, background=False)
        max_seq = serve_ranks.S + serve_ranks.DECODE
        prefill_fn, decode_fn, _ = launch.build_model_fns(
            params, cfg, max_seq=max_seq, decode_tokens=serve_ranks.DECODE,
            index=idx, resume=resume)
        reqs = serve_ranks.requests(cfg.vocab_size)
        with NoFunctionalGather() as guard:
            recs = launch.run_request_loop(launch.MeshLookups(queue), reqs,
                                           prefill_fn=prefill_fn,
                                           decode_fn=decode_fn)
        queue.close()
        for i, r in enumerate(recs):
            out[f"{arch}/rec{i}/counts"] = np.array(
                [r.chunks, r.hit_chunks, r.resumed_chunks, r.admitted])
            out[f"{arch}/rec{i}/decoded"] = r.decoded
        out[f"{arch}/gathers"] = np.array([guard.counts["all-gather"],
                                           guard.nbytes["all-gather"]])
        if resume:
            continue
        logits, cache = transformer.prefill(params, cfg,
                                            {"tokens": reqs[0]}, max_seq)
        tokens = greedy(logits)
        with NoFunctionalGather() as guard:
            transformer.decode_step(params, cfg, tokens, cache,
                                    serve_ranks.S)
        out[f"{arch}/step_gathers"] = np.array(
            [guard.counts["all-gather"], guard.nbytes["all-gather"]])

    x = DTensor.from_local(torch.arange(4.0) + 4 * rank, dm,
                           [Replicate(), Shard(0)], run_check=False)
    try:
        with NoFunctionalGather():
            x.redistribute(dm, [Replicate(), Replicate()])
        out["guard/fired"] = np.array("")
    except FunctionalGather as e:
        out["guard/fired"] = np.array(str(e))
    with NoFunctionalGather():
        out["guard/raw"] = sharding.redistribute(
            x, [Replicate(), Replicate()]).to_local().numpy()
    return out


def gather(rank: int, port: int, workdir: str) -> dict:
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist import sharding
    from repro_torch.models import layers

    dm = join(rank, port, GATHER_WORLD, GATHER_SHAPE)
    out = {}
    for case, (codes, dim, dst_codes) in GATHER_CASES.items():
        src = [placement(c) for c in codes]
        dst = [placement(c) for c in dst_codes]
        # the global tensor, and this rank's own draw for a partial block
        g = torch.Generator().manual_seed(len(case))
        glob = torch.randn((4, 8, 6), generator=g)
        own = torch.randn((4, 8, 6), generator=torch.Generator().manual_seed(
            100 + rank))
        block = glob if not any(p.is_partial() for p in src) else own
        off, size = sharding.block_bounds(glob.shape, src, dm)
        local = block[tuple(slice(o, o + n) for o, n in zip(off, size))]
        weight = torch.randn((4, 8, 6), generator=g)

        def placed():
            leaf = local.clone().requires_grad_(True)
            return leaf, DTensor.from_local(leaf, dm, src, run_check=False)

        whole = [Replicate() if p == placement(f"S{dim}") else p
                 for p in src]
        runs = {
            "full": (lambda t: sharding.full(t),
                     lambda t: t.full_tensor()),
            "replicate_dim": (
                lambda t: sharding.replicate_dim(t, dim).to_local(),
                lambda t: t.redistribute(dm, whole).to_local()),
            "redistribute": (
                lambda t: sharding.redistribute(t, dst).to_local(),
                lambda t: t.redistribute(dm, dst).to_local()),
        }
        for name, fns in runs.items():
            for who, fn in zip(("raw", "dtensor"), fns):
                leaf, t = placed()
                with NoFunctionalGather(raises=False) as guard:
                    got = fn(t)
                    w = weight[tuple(slice(0, n) for n in got.shape)]
                    (got * w).sum().backward()
                out[f"{case}/{name}/{who}"] = got.detach().numpy()
                out[f"{case}/{name}/{who}_grad"] = leaf.grad.numpy()
                out[f"{case}/{name}/{who}_functional"] = np.asarray(
                    guard.fired)
    for case, (shape, x_codes, w_codes, cdim) in ROW_CASES.items():
        g = torch.Generator().manual_seed(7 + len(case))
        xg, wg = torch.randn(shape, generator=g), torch.randn((6, 5),
                                                               generator=g)
        weight = torch.randn(shape[:cdim] + (5,), generator=g)
        for who in ("raw", "dtensor"):
            leaves, ops = [], []
            for glob, codes in ((xg, x_codes), (wg, w_codes)):
                pl = [placement(c) for c in codes]
                off, size = sharding.block_bounds(glob.shape, pl, dm)
                leaf = glob[tuple(slice(o, o + n) for o, n in
                                  zip(off, size))].clone().requires_grad_()
                leaves.append(leaf)
                ops.append(DTensor.from_local(leaf, dm, pl, run_check=False))
            with NoFunctionalGather(raises=False) as guard:
                if who == "raw":
                    got = sharding.full(layers.row_parallel(*ops, cdim=cdim))
                else:            # the whole operands' product
                    x, w = (t.full_tensor() for t in ops)
                    got = x.reshape(shape[:cdim] + (-1,)) @ w
                (got * weight).sum().backward()
            out[f"row/{case}/{who}"] = got.detach().numpy()
            out[f"row/{case}/{who}_grad_x"] = leaves[0].grad.numpy()
            out[f"row/{case}/{who}_grad_w"] = leaves[1].grad.numpy()
            out[f"row/{case}/{who}_functional"] = np.asarray(guard.fired)
    cols = [torch.arange(6.0).reshape(2, 3) + 10 * rank,
            torch.arange(2.0).reshape(2, 1) - 10 * rank]
    for j, t in enumerate(sharding.gather_columns(cols, dm, (0, 1))):
        out[f"columns/{j}"] = t.numpy()
    return out


def main(mode: str, rank: int, port: int, workdir: str) -> None:
    out = {"serve": serve, "gather": gather}[mode](rank, port, workdir)
    np.savez(os.path.join(workdir, f"{mode}{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
