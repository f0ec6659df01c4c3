"""Plain PyTorch version of the hopscotch window lookup.

Monarch semantics (paper §9.2.2): a hash-table lookup probes the H buckets
of the key's hopscotch window in ONE search.  Per query, the offset
(0..H-1) of the first bucket whose stored 64-bit key (lo and hi 32-bit
halves, held as int32 bit patterns) equals the query key, else -1 — the
reference oracle ``repro/kernels/hopscotch/ref.py:hopscotch_lookup_ref``.
A slot outside ``[0, N)`` never matches, as in the CUDA kernel (the
reference's tables always carry enough pad for a window).

Runs on CPU and CUDA tensors alike: the CPU tests use it in place of the
kernel, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def hopscotch_lookup_plain(table_lo: torch.Tensor, table_hi: torch.Tensor,
                           homes: torch.Tensor, q_lo: torch.Tensor,
                           q_hi: torch.Tensor, window: int) -> torch.Tensor:
    """table_lo/hi (N,) int32; homes/q_lo/q_hi (Q,) int32 -> (Q,) int32."""
    n = table_lo.shape[0]
    if n == 0:
        return torch.full_like(homes, -1, dtype=torch.int32)
    idx = homes.long()[:, None] + torch.arange(window, device=homes.device)
    inside = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    match = (inside & (table_lo[idx] == q_lo[:, None])
             & (table_hi[idx] == q_hi[:, None]))
    first = match.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(match.any(dim=1), first, -1).to(torch.int32)
