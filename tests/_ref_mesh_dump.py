"""Drive the reference's set-sharded index over four host devices and dump
its state after every op (helper of tests/test_torch_kv_index_mesh.py;
not collected).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/_ref_mesh_dump.py OUT.npz

With four devices the reference's ``"auto"`` index at four shards holds
four partitions: a lookup is its ``shard_map`` search, an admission its
``shard_map`` round grid and a rotation its ``ppermute`` boundary
exchange.  One seeded admit / re-offer / lookup / rotate schedule runs
through an int8 and a packed8 index.  The npz holds the schedule (each
op and its input), the state after every op, and ``set_partitions`` and
``set_shard_devices`` (as device ids) for 1 to 8 shards.
"""
from __future__ import annotations

import os
import sys

import numpy as np

FORMATS = ("int8", "packed8")
N_SHARDS = 4
STEPS = 14
CFG = dict(n_sets=8, set_ways=4, admit_after_reads=1, m_writes=1,
           window_ops=64, rotate_every=1 << 30, n_shards=N_SHARDS)
WEAR_FIELDS = ("swt_w", "swt_d", "window_writes", "window_start",
               "locked_until", "write_counter", "superset_counter",
               "dirty_counter")


def schedule(seed: int = 23) -> list:
    """``[(op, payload)]``: op 0 admits payload's fingerprints, 1 admits
    them twice (the re-offer crosses the no-allocate gate), 2 looks up
    payload's tokens (half of the time tokens admitted before, so
    lookups hit), 3 rotates.  Every op kind occurs."""
    from repro.data.pipeline import fingerprint_blocks
    rng = np.random.default_rng(seed)
    ops, seen = [], []
    for step in range(STEPS):
        toks = rng.integers(1, 600, (2, 96)).astype(np.int32)
        u = rng.random()
        if step % 5 == 4:
            ops.append((3, np.zeros(0, np.uint32)))
        elif u < 0.55:
            fps = np.unique(fingerprint_blocks(toks, 16).reshape(-1))
            ops.append((1 if u < 0.35 else 0, fps))
            seen.append(toks)
        else:
            ops.append((2, seen[int(u * 100) % len(seen)]
                        if seen and u > 0.75 else toks))
    return ops


def state_of(idx) -> dict:
    """The index's state as arrays (the shadow map as sorted rows)."""
    ws = idx.wear_state
    out = {name: np.asarray(getattr(idx, name)) for name in (
        "bits", "valid", "fp_of", "read_after", "set_writes", "counter")}
    for f in WEAR_FIELDS:
        out["wear_" + f] = np.asarray(getattr(ws, f))
    s = idx.stats
    out["stats"] = np.asarray([s.lookups, s.chunk_hits, s.chunk_misses,
                               s.admissions, s.admission_skips, s.throttled,
                               s.evictions, s.rotations, s.searches,
                               s.admit_calls, idx.offset, idx.ops_total,
                               idx.wear_report()["throttled_sets_now"]],
                              np.int64)
    out["slot_of"] = np.asarray(sorted(
        (fp, s_, w) for fp, (s_, w) in idx.slot_of.items()),
        np.int64).reshape(-1, 3)
    return out


def main(path: str) -> None:
    import jax
    from repro.launch import mesh
    from repro.serve.kv_index import KVIndexConfig, MonarchKVIndex

    if len(jax.devices()) != 4:
        raise SystemExit(f"needs 4 host devices, has {len(jax.devices())}")
    dump = {"set_partitions": np.asarray(
        [mesh.set_partitions(n) for n in range(1, 9)], np.int64)}
    for n in range(1, 9):
        devs = mesh.set_shard_devices(mesh.make_set_mesh(n), n)
        dump[f"shard_devices_{n}"] = np.asarray(
            [-1] if devs is None else [d.id for d in devs], np.int64)
    ops = schedule()
    for i, (op, payload) in enumerate(ops):
        dump[f"op_{i}"] = np.asarray(op)
        dump[f"payload_{i}"] = payload
    for fmt in FORMATS:
        idx = MonarchKVIndex(KVIndexConfig(plane_format=fmt, **CFG))
        if idx.n_parts != N_SHARDS or not idx._use_shard_map:
            raise SystemExit(f"reference index holds {idx.n_parts} parts")
        for i, (op, payload) in enumerate(ops):
            if op in (0, 1):
                for _ in range(op + 1):
                    idx.admit_fps(payload)
            elif op == 2:
                dump[f"{fmt}_hits_{i}"] = idx.lookup(payload)
            else:
                idx._rotate()
            for key, v in state_of(idx).items():
                dump[f"{fmt}_{i}_{key}"] = v
    np.savez(path, **dump)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1])
