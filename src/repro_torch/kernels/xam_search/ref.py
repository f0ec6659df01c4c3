"""Plain PyTorch versions of the XAM searches: the fused multi-set search
and the flat search (``xam_search_plain``, a (Q, C) bitmap).

Semantics (paper §4.2.2): a stored column matches a (key, mask) pair iff
every *masked-in* key bit equals the stored bit in that row of the column.
The fused multi-set search answers, for every query, the first column of
its block's set plane that is valid and matches — the reference oracle
``repro/kernels/xam_search/ref.py:xam_search_multiset_ref`` — plus the
launch-layout rules the kernel applies: a query in a dead block
(``live_blocks == 0``) and a query whose mask row is all zero report -1.

Written as a broadcast compare-and-``all`` (no integer matmul, which CUDA
lacks) so it runs on CPU and CUDA tensors alike: the CPU tests use it in
place of the kernel, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.
"""
from __future__ import annotations

import torch


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """(..., rp, C) uint8 packed words -> (..., rp*8, C) int8 {0,1} bits,
    LSB-first: logical row ``r`` is bit ``r % 8`` of packed row ``r // 8``."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32).unsqueeze(-2)
            >> shifts[:, None]) & 1                    # (..., rp, 8, C)
    return bits.reshape(*packed.shape[:-2], packed.shape[-2] * 8,
                        packed.shape[-1]).to(torch.int8)


def xam_search_multiset_plain(keys: torch.Tensor, masks: torch.Tensor,
                              planes: torch.Tensor, valid: torch.Tensor,
                              block_sets: torch.Tensor,
                              live_blocks: torch.Tensor, *,
                              block_q: int) -> torch.Tensor:
    """keys/masks (Q, R) int8; planes (n_sets, R, C) int8 or (n_sets, R/8,
    C) uint8 packed; valid (n_sets, C) int8; block_sets/live_blocks
    (Q/block_q,) int32.  Returns (Q,) int32: the first valid matching way
    of plane ``block_sets[q // block_q]``, else -1."""
    if planes.dtype == torch.uint8:
        planes = unpack_rows(planes)
    set_ids = block_sets.long().repeat_interleave(block_q)          # (Q,)
    live = live_blocks.repeat_interleave(block_q) != 0
    d = planes[set_ids]                                             # (Q, R, C)
    eq = (keys[:, :, None] == d) | (masks[:, :, None] == 0)
    m = eq.all(dim=1) & (valid[set_ids] == 1)                       # (Q, C)
    first = torch.where(m.any(dim=1), m.to(torch.int32).argmax(dim=1), -1)
    row_live = (masks != 0).any(dim=1) & live
    return torch.where(row_live, first, -1).to(torch.int32)


def xam_search_plain(keys: torch.Tensor, data: torch.Tensor,
                     masks: torch.Tensor) -> torch.Tensor:
    """The flat search: keys/masks (Q, R) int8 {0,1}; data (R, C) int8 or
    (Rp, C) uint8 packed words with ``Rp * 8 >= R``.  Returns the (Q, C)
    int8 bitmap ``AND_r (mask == 0 or key == data)`` — the reference's
    ``xam_search_ref``; an all-zero mask row matches every column.  A
    loop over the R rows keeps the working set at (Q, C)."""
    if data.dtype == torch.uint8:
        data = unpack_rows(data)
    q, r = keys.shape
    acc = torch.ones((q, data.shape[1]), dtype=torch.bool,
                     device=data.device)
    for row in range(r):
        acc &= (keys[:, row, None] == data[row]) | (masks[:, row, None] == 0)
    return acc.to(torch.int8)


def first_match(m: torch.Tensor) -> torch.Tensor:
    """(Q, C) bitmap -> (Q,) int32 first column with a 1, -1 when none."""
    first = m.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where((m == 1).any(dim=1), first, -1).to(torch.int32)


def xam_match_index_plain(keys: torch.Tensor, data: torch.Tensor,
                          masks: torch.Tensor) -> torch.Tensor:
    """First matching column per query, -1 when none (match register)."""
    return first_match(xam_search_plain(keys, data, masks))
