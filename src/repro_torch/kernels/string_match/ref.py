"""Plain PyTorch version of the sliding exact string match.

match[i] = 1 iff text[i : i+P] == pattern, for i in [0, N-P]; positions
past N-P are 0, and every position is 0 when P > N — the reference oracle
``repro/kernels/string_match/ref.py:string_match_ref``.  Compares bytes
directly (no int32 upcast).  Runs on CPU and CUDA tensors alike.
"""
from __future__ import annotations

import torch


def string_match_plain(text: torch.Tensor,
                       pattern: torch.Tensor) -> torch.Tensor:
    """text (N,) uint8, pattern (P,) uint8 -> (N,) int8 match-start flags."""
    n, p = text.shape[0], pattern.shape[0]
    out = torch.zeros(n, dtype=torch.int8, device=text.device)
    if p > n:
        return out
    m = min(n - p + 1, n)               # positions a match may start at
    acc = torch.ones(m, dtype=torch.bool, device=text.device)
    for k in range(p):
        acc &= text[k:k + m] == pattern[k]
    out[:m] = acc.to(torch.int8)
    return out
