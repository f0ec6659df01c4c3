"""Numpy makers of the edge cases of the XAM searches and the hopscotch
lookup: 4-column vectors and column chunks, word-count templates, staged
query chunks, block minima, lane groups and window steps.  ``chip_smoke.py`` and the card tests hold the kernels against their
plain versions on these cases; the CPU tests hold the plain versions
against the JAX package on the same ones."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.common import pack_bits_np

MULTISET_EDGE_COLS = (0, 3, 4, 127, 128, 511)

#: A flat search off every boundary of the kernel's layout: C not a
#: multiple of 4 (a ragged last column vector), R not a multiple of 32 or
#: of 8 (a partial key word, a padded packed word), Q over two staged
#: query chunks of 64.
FLAT_RAGGED_SHAPE = (130, 45, 1001)


def multiset_edge_case(seed: int, r: int, c: int, block_q: int = 16,
                       packed: bool = False):
    """A set-grouped batch at the multi-set search's edges, as numpy arrays
    ``(keys, masks, planes, valid, block_sets, live_blocks, firsts)``.

    One set per target column t (each of 0, 3, 4, 127, 128 and 511 below C,
    and C - 1).  Query 0 of its block matches columns t, t + 1 and C - 1,
    all valid, and no valid column below t (those differ in row 0, and
    t - 1 matches but is invalid); query 1 has an all-zero mask; every third
    query is a stored column of the set under a full mask; the rest have
    random keys and partial masks.  Then a dead block and a block on a set
    with no valid way.  ``firsts`` holds query 0's answer per target block.
    ``packed`` pads R to a multiple of 8 with zero rows and packs the planes
    (packed8)."""
    rng = np.random.default_rng(seed)
    targets = sorted({t for t in MULTISET_EDGE_COLS if t < c} | {c - 1})
    n_sets = len(targets) + 1                  # the last: no valid way
    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    valid[-1] = 0
    block_sets = np.asarray(list(range(len(targets))) + [0, n_sets - 1],
                            np.int32)
    live = np.ones(len(block_sets), np.int32)
    live[-2] = 0                               # the dead block
    q = len(block_sets) * block_q
    keys = rng.integers(0, 2, (q, r)).astype(np.int8)
    masks = (rng.random((q, r)) < 0.3).astype(np.int8)
    for b, t in enumerate(targets):
        key = keys[b * block_q]
        planes[b, 0, :t] = 1 - key[0]
        for col in (t, min(t + 1, c - 1), c - 1):
            planes[b, :, col] = key
            valid[b, col] = 1
        if t > 0:
            planes[b, :, t - 1] = key
            valid[b, t - 1] = 0
    for i in range(2, q, 3):                   # stored columns, full masks
        if i < len(targets) * block_q and i % block_q < 2:
            continue                           # the target rows stay
        keys[i] = planes[block_sets[i // block_q], :,
                         int(rng.integers(0, c))]
        masks[i] = 1
    starts = np.arange(len(targets)) * block_q
    masks[starts] = 1
    masks[starts + 1] = 0
    if packed:
        r8 = -(-r // 8) * 8
        pad = lambda x, axis: np.concatenate(
            [x, np.zeros(x.shape[:axis] + (r8 - r,) + x.shape[axis + 1:],
                         np.int8)], axis=axis)
        keys, masks = pad(keys, 1), pad(masks, 1)
        planes = pack_bits_np(pad(planes, 1), axis=1)
    return keys, masks, planes, valid, block_sets, live, targets


def flat_edge_case(seed: int, q: int, r: int, c: int):
    """``(keys, masks, data)`` int8 {0,1} arrays of a (Q, R) x (R, C) flat
    search: every third query's key stored in a column (the last column
    for query 0) under a full mask, every seventh mask all zero (the row
    matches every column), every fifth mask clearing the key's low half,
    the rest random keys under random masks."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (q, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    masks = (rng.random((q, r)) < 0.9).astype(np.int8)
    for i in range(0, q, 3):
        data[:, c - 1 if i == 0 else (7 * i) % c] = keys[i]
        masks[i] = 1
    masks[1::7] = 0
    masks[4::5, : r // 2] = 0
    return keys, masks, data


def hop_edge_case(seed: int, window: int):
    """``(t_lo, t_hi, homes, q_lo, q_hi)`` int32 arrays over a table of
    6 H + 5 slots with unique full-width keys.  Query o (o < H) looks for
    the key planted at offset o of its window and nowhere earlier, so every
    lane, lane group and step of a window holds some query's first hit;
    every other one has a second copy later in its window (the first
    wins).  Offset 0's window runs past N and offset H - 1's starts below 0.
    Then homes at -H, -1, 3, N - 1, N and N + 5, each looking for the key at
    home + H clipped into the table: past its window, or (home N - 1) at its
    offset 0; the windows at and past N, and at -H, lie outside the table."""
    rng = np.random.default_rng(seed)
    n = 6 * window + 5
    t_lo = ((np.arange(n, dtype=np.uint64) * np.uint64(2654435761)
             + np.uint64(seed)) % np.uint64(1 << 32)).astype(np.uint32)
    t_hi = rng.integers(0, 1 << 31, n, dtype=np.uint32)
    slots = rng.permutation(n)[:window]
    for o, want in [(0, n - 1)] + ([(window - 1, 0)] if window > 1 else []):
        slots[slots == want] = slots[o]
        slots[o] = want
    homes = list(slots - np.arange(window))
    planted = set(slots.tolist())
    for o in range(0, window - 1, 2):
        at = homes[o] + int(rng.integers(o + 1, window))
        if 0 <= at < n and at not in planted:
            t_lo[at], t_hi[at] = t_lo[slots[o]], t_hi[slots[o]]
    keys = [int(s) for s in slots]
    for home in (-window, -1, 3, n - 1, n, n + 5):
        homes.append(home)
        keys.append(min(max(home + window, 0), n - 1))
    keys = np.asarray(keys)
    return (t_lo.view(np.int32), t_hi.view(np.int32),
            np.asarray(homes, np.int32), t_lo[keys].view(np.int32),
            t_hi[keys].view(np.int32))
