"""Fig. 6 reproduction on the PyTorch port: a key-value store on the
flat-CAM/flat-RAM scratchpads, then the same workload on the Hopscotch
table whose lookup path is ONE Monarch search per window (paper §9.2.2);
the port's counterpart of ``examples/kv_store.py``.  On the card the
flat-CAM searches run the flat-search CUDA kernel
(``kernels/xam_search/csrc/xam_search.cu``) and the window lookups the
hopscotch kernel (``kernels/hopscotch/csrc/hopscotch_lookup.cu``); on the
CPU their plain versions.

    PYTHONPATH=src python examples/kv_store_torch.py
    PYTHONPATH=src python examples/kv_store_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.apps.hashtable import HopscotchTable
from repro_torch.core.api import MonarchDevice
from repro_torch.data import pipeline
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def fig6_flow(dev: torch.device):
    print("== Fig. 6: flat-CAM key-value store ==")
    mdev = MonarchDevice(n_sets=8, key_bits=64, set_cols=64, device=dev)
    keys = mdev.flat_cam_malloc(64)    # myKEYS
    data = mdev.flat_ram_malloc(64)    # myDATA
    rng = np.random.default_rng(1)
    stored = {}
    for i in range(64):
        k = int(rng.integers(1, 1 << 48))
        stored[k] = i * 10
        mdev.cam_write(keys, i, k)     # write keys column-wise (ColumnIn CAM)
        mdev.ram_write(data, i, i * 10)
    probe = list(stored)[17]
    _sync(dev)
    t0 = time.time()
    v = mdev.kv_lookup(keys, data, probe)
    print(f"lookup({probe:#x}) = {v} (expect {stored[probe]}) "
          f"in {(time.time() - t0) * 1e3:.1f} ms")
    n_search = sum(1 for c in mdev.command_log if c.startswith("S "))
    print(f"commands: {n_search} search(es) for a 64-entry store "
          f"(baseline would serially read up to 64 words)\n")


def hopscotch_ycsb(dev: torch.device):
    print("== Hopscotch + YCSB-B (95% reads), Monarch search lookups ==")
    t = HopscotchTable(12, window=32, device=dev)
    ycsb = pipeline.YcsbConfig(n_keys=2000, n_ops=4000, read_fraction=0.95)
    keys, is_read = pipeline.ycsb_ops(ycsb)
    # load phase
    for k in np.unique(keys[is_read]):
        t.insert(int(k), int(k) % 997)
    # run phase: batched CAM lookups for reads, inserts for writes
    _sync(dev)
    t0 = time.time()
    r_keys = keys[is_read]
    vals, hits = t.lookup_monarch(r_keys)
    for k in keys[~is_read]:
        t.insert(int(k), 1)
    _sync(dev)
    dt = time.time() - t0
    s = t.stats
    print(f"{len(r_keys)} lookups ({hits.mean():.1%} hit), "
          f"{(~is_read).sum()} inserts in {dt:.2f}s")
    print(f"op counts: searches={s.searches} (Monarch) vs probes the "
          f"baseline would issue serially; writes={s.writes}, "
          f"swaps={s.swaps}, rehashes={s.rehashes}")
    print(f"load factor {t.load:.2f}; window invariant holds -> every "
          f"lookup is ONE search command covering the whole window")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fig6_flow(dev)
    hopscotch_ycsb(dev)


if __name__ == "__main__":
    main()
