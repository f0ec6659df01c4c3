"""String-Match application (paper §9.2.3 / §10.5, Phoenix kernel) — port
of ``repro/apps/stringmatch.py``.

Monarch flow: the dataset is copied from DDRx into CAM arrays with 64-bit
block boundaries as word delimiters — an 8x storage blow-up (bit-planes) +
a preprocessing pass — after which each search command covers 4 KB of
data.  The baseline streams the dataset through the cache hierarchy in
64 B lines.  The op counts reported here feed the timing model; the
matching itself runs on the string-match kernel (a Hopper kernel on the
card, one launch per :func:`find`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.string_match import ops as sm_ops

SEARCH_COVERAGE = 4096      # bytes per Monarch search command
LINE = 64                   # baseline cache-line bytes
BLOWUP = 8                  # bit-plane storage expansion (paper §10.5)


@dataclasses.dataclass
class MatchReport:
    n_matches: int
    monarch_searches: int
    monarch_copy_bytes: int   # preprocessing writes into CAM (8x data)
    baseline_line_reads: int


def find(text, pattern: bytes,
         device: str | torch.device = "cuda") -> MatchReport:
    """Count the matches of ``pattern`` in ``text`` (a (N,) uint8 array,
    or a uint8 tensor, which stays on its own device; a host array is
    copied to ``device``, default ``"cuda"``, which raises without a
    card)."""
    if not isinstance(text, torch.Tensor):
        text = torch.from_numpy(np.asarray(text, np.uint8)).to(
            resolve_device(device))
    pat = torch.frombuffer(bytearray(pattern), dtype=torch.uint8).to(
        text.device)
    matches = int(sm_ops.count_matches(text, pat))
    n = text.shape[0]
    return MatchReport(
        n_matches=matches,
        monarch_searches=(n + SEARCH_COVERAGE - 1) // SEARCH_COVERAGE,
        monarch_copy_bytes=n * BLOWUP,
        baseline_line_reads=(n + LINE - 1) // LINE,
    )


def make_corpus(n_bytes: int, seed: int = 0, alphabet: int = 16) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(97, 97 + alphabet, n_bytes)).astype(np.uint8)
