"""§10.5 String-Match in flat-CAM mode on the PyTorch port: broadcast
searches covering 4 KB per command, with the copy-in preprocessing + 8x
blow-up the paper charges (the port's counterpart of
``examples/string_search.py``).  The count runs the string-match CUDA
kernel (``kernels/string_match/csrc/string_match.cu``) on the card, its
plain version on the CPU.

    PYTHONPATH=src python examples/string_search_torch.py [--mib 1]
    PYTHONPATH=src python examples/string_search_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.apps import stringmatch
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=float, default=1.0)
    ap.add_argument("--pattern-len", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = int(args.mib * 2 ** 20)
    corpus = stringmatch.make_corpus(n, seed=11)
    start = n // 3
    pattern = bytes(corpus[start:start + args.pattern_len])

    t0 = time.time()
    rep = stringmatch.find(corpus, pattern, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    route = ("CUDA kernel on the card" if dev.type == "cuda"
             else "plain version on the CPU")
    print(f"corpus {args.mib} MiB, pattern {pattern!r}")
    print(f"matches: {rep.n_matches} in {dt:.2f}s ({route})")
    print(f"Monarch op counts: {rep.monarch_searches} search commands "
          f"(4 KB coverage each) after a copy-in of "
          f"{rep.monarch_copy_bytes / 2 ** 20:.0f} MiB (8x bit-plane "
          f"blow-up, charged as in §10.5)")
    print(f"baseline op counts: {rep.baseline_line_reads} 64 B line reads "
          f"streamed through the cache hierarchy")
    ratio = rep.baseline_line_reads / rep.monarch_searches
    print(f"request-count reduction: {ratio:.0f}x fewer memory commands")


if __name__ == "__main__":
    main()
