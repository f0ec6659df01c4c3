"""Quickstart on the PyTorch port: the Monarch XAM primitive in 60 seconds
(the port's counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. Build a XAM set (64 x 512 bit plane), store keys column-wise.
2. Run ONE masked CAM search over all 512 columns (the paper's §4.2.2
   operation): on the card the flat-search CUDA kernel
   (``kernels/xam_search/csrc/xam_search.cu``), on the CPU its plain
   version.
3. Same flow through the user-space API (Fig. 6 key-value store), whose
   searches go through the same kernel.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import xam
from repro_torch.core.api import MonarchDevice
from repro_torch.device import resolve_device
from repro_torch.kernels.xam_search import ops as xam_ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(7)

    # --- 1. raw XAM set -----------------------------------------------
    arr = xam.make_set(device=dev)             # 64 rows x 512 columns
    key = torch.from_numpy(rng.integers(0, 2, 64).astype(np.int8)).to(dev)
    arr = xam.store_key_colwise(arr, 137, key)
    matches, idx = xam.set_search(arr, key, torch.ones(64, dtype=torch.int8,
                                                       device=dev))
    print(f"[xam]    stored the key at column 137; search found column "
          f"{int(idx)} ({int(matches.sum())} match)")

    # --- 2. batched search kernel ---------------------------------------
    keys = rng.integers(0, 2, (8, 64)).astype(np.int8)     # 8 queries
    data = rng.integers(0, 2, (64, 512)).astype(np.int8)   # one set plane
    data[:, 42] = keys[3]                                  # plant a match
    hits = xam_ops.xam_search(keys, torch.from_numpy(data).to(dev))
    print(f"[kernel] query 3 matches columns "
          f"{np.nonzero(hits[3].cpu().numpy())[0].tolist()}")

    # --- 3. Fig. 6 software flow ---------------------------------------
    mdev = MonarchDevice(n_sets=4, key_bits=64, set_cols=8, device=dev)
    keys_alloc = mdev.flat_cam_malloc(16)
    data_alloc = mdev.flat_ram_malloc(16)
    kv = {0xCAFE: 101, 0xBEEF: 202, 0xF00D: 303}
    for i, (k, v) in enumerate(kv.items()):
        mdev.cam_write(keys_alloc, i, k)
        mdev.ram_write(data_alloc, i, v)
    for k in (0xBEEF, 0xDEAD):
        print(f"[api]    kv_lookup(0x{k:X}) -> "
              f"{mdev.kv_lookup(keys_alloc, data_alloc, k)}")
    # masked partial search: match on the high byte only
    print(f"[api]    masked lookup (key=0xF000, mask=0xFF00) -> "
          f"{mdev.kv_lookup(keys_alloc, data_alloc, 0xF000, mask=0xFF00)}")
    print(f"[api]    command log: {mdev.command_log[-4:]}")


if __name__ == "__main__":
    main()
