"""One rank of the port's serving over a (2, 2) ("data", "model") mesh of
four gloo processes on the CPU (helper of tests/test_torch_mesh_serve.py;
not collected; imports no JAX).

    PYTHONPATH=src python tests/_torch_mesh_serve_ranks.py RANK PORT WORKDIR

``WORKDIR/params.npz`` holds each case's parameters (``{arch}/{leaf
path}``, the reference's ``init_params`` as numpy, bf16 leaves as their
uint16 bits).  For each arch of :data:`CASES` the rank places them by
``param_specs``, builds its own index replica, admission queue and
(resume) slab store, and serves :func:`requests` through the launcher's
pieces: ``build_model_fns`` and ``run_request_loop`` over
``MeshLookups`` (the hit masks checked across the ranks after every
lookup).  It writes each batch's record (``{arch}/rec{i}/...``) and its
index replica's placement (``{arch}/slot_of``, ``{arch}/bits``).  Then
the wear clock: :data:`WEAR_BATCHES` batches of fresh chunks through an
index whose t_MWW budget throttles, under ``clock="wall"`` read from the
launchers' shared ``MeshClock`` (each rank's own clock runs at another
rate), recording placement, throttles and wear state (``wear/...``).
Last, yi-9b again with rank 1's hit mask flipped in one chunk, recording
what each rank raised (``diverged``) and what a later lookup raised
(``after``).  Output: ``WORKDIR/rank{RANK}.npz``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_ranks import tree_of  # noqa: E402  (numpy only)

WORLD = 4
#: arch -> resume: yi-9b and qwen3-moe-30b-a3b (experts over ``model``)
#: resume from slabs; falcon-mamba-7b serves with resume off
CASES = {"yi-9b": True, "qwen3-moe-30b-a3b": True, "falcon-mamba-7b": False}
S, B, DECODE = 48, 2, 3
#: the wear clock's case: batches of (B, 4 chunks) of fresh tokens over
#: an index of 8 x 4 ways that may write each way once per 10 s window
WEAR_BATCHES = 12
WEAR_CONFIG = dict(n_sets=8, set_ways=4, m_writes=1, window_ops=10_000_000,
                   clock="wall", admit_after_reads=0, rotate_every=1 << 30)


def requests(vocab: int, n_batches: int = 6, seed: int = 0) -> list:
    """Zipf-ish prompts (``tests/test_torch_serve.py``'s): a few shared
    32-token prefixes, rank-skewed, with random 16-token tails, so later
    batches hit earlier chunks."""
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(1, vocab, (3, 32)).astype(np.int32)
    p = 1.0 / np.arange(1, 4) ** 1.2
    out = []
    for _ in range(n_batches):
        pick = rng.choice(3, size=B, p=p / p.sum())
        tails = rng.integers(1, vocab, (B, S - 32)).astype(np.int32)
        out.append(np.concatenate([prefixes[pick], tails], axis=1))
    return out


def kv_config(resume: bool) -> dict:
    return dict(n_sets=8, fingerprint="prefix" if resume else "block",
                admit_after_reads=0)


def wear_requests(seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1 << 20, (B, 64)).astype(np.int32)
            for _ in range(WEAR_BATCHES)]


def placed(flat: dict, arch: str, dm) -> dict:
    """``arch``'s parameters of ``flat`` (``params.npz``) placed over
    ``dm`` by ``param_specs``."""
    from repro_torch.dist import sharding
    from repro_torch.pytree import tree_map

    def leaf(a):
        t = torch.from_numpy(np.array(a))
        return t.view(torch.bfloat16) if a.dtype == np.uint16 else t
    params = tree_map(leaf, tree_of(flat, arch))
    return sharding.place(params, sharding.param_specs(params, dm), dm)


def main(rank: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.serve.admit_queue import AdmitQueue
    from repro_torch.serve.kv_index import (KVIndexConfig, KVSlabStore,
                                            MonarchKVIndex)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    dm = device_mesh(Mesh(("data", "model"), (2, 2)), "cpu")
    flat = dict(np.load(os.path.join(workdir, "params.npz")))
    out = {}

    def stack(arch, resume):
        cfg = configs.get_arch(arch).reduced()
        idx = MonarchKVIndex(KVIndexConfig(**kv_config(resume)), device="cpu",
                             slab_store=KVSlabStore() if resume else None)
        queue = AdmitQueue(idx, background=False)
        prefill_fn, decode_fn, _ = serve.build_model_fns(
            placed(flat, arch, dm), cfg, max_seq=S + DECODE, decode_tokens=DECODE,
            index=idx, resume=resume)
        return cfg, idx, queue, prefill_fn, decode_fn

    for arch, resume in CASES.items():
        cfg, idx, queue, prefill_fn, decode_fn = stack(arch, resume)
        recs = serve.run_request_loop(
            serve.MeshLookups(queue), requests(cfg.vocab_size),
            prefill_fn=prefill_fn, decode_fn=decode_fn)
        queue.close()
        for i, r in enumerate(recs):
            out[f"{arch}/rec{i}/counts"] = np.array(
                [r.chunks, r.hit_chunks, r.resumed_chunks, r.admitted])
            out[f"{arch}/rec{i}/decoded"] = r.decoded
        keys = sorted(idx.slot_of)
        out[f"{arch}/slot_of"] = np.array(
            [[k, *np.ravel(idx.slot_of[k])] for k in keys], np.int64)
        out[f"{arch}/bits"] = idx.bits.numpy()

    import dataclasses
    import time
    clock = serve.MeshClock(time_fn=lambda: time.monotonic() * (1 + rank))
    idx = MonarchKVIndex(KVIndexConfig(**WEAR_CONFIG), device="cpu",
                         now_fn=clock.now)
    queue = AdmitQueue(idx, background=False)
    serve.run_request_loop(serve.MeshLookups(queue, clock=clock),
                           wear_requests(), prefill_fn=lambda t, h: None)
    queue.close()
    out["wear/slot_of"] = np.array(
        [[k, *np.ravel(v)] for k, v in sorted(idx.slot_of.items())], np.int64)
    out["wear/bits"] = idx.bits.numpy()
    out["wear/counts"] = np.array([idx.stats.admissions, idx.stats.throttled,
                                   idx.wear_report()["throttled_sets_now"]])
    out["wear/clock"] = np.array(clock.now())

    def state(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                state(f"{prefix}{f.name}/", v)
            else:
                out[f"{prefix}{f.name}"] = v.numpy()
    state("wear/state/", idx.wear_state)

    cfg, idx, queue, prefill_fn, decode_fn = stack("yi-9b", True)
    if rank == 1:                     # this replica answers one chunk wrong
        lookup = queue.lookup

        def skewed(tokens):
            hits = np.array(lookup(tokens))
            hits[0, 0] = not hits[0, 0]
            return hits
        queue.lookup = skewed
    lookups = serve.MeshLookups(queue)
    reqs = requests(cfg.vocab_size)
    for key, batch in (("diverged", reqs[:1]), ("after", reqs[1:2])):
        try:                          # the second raises with no collective
            serve.run_request_loop(lookups, batch, prefill_fn=prefill_fn,
                                   decode_fn=decode_fn)
            out[key] = np.array("")
        except serve.HitsDiverged as e:
            out[key] = np.array(str(e))
    queue.close()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
