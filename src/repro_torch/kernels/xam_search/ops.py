"""Public wrappers for the XAM search kernels (port of the flat search
and the one-device half of ``repro/kernels/xam_search/ops.py``).

The host groups a query batch into per-set blocks of ``block_q`` queries
(:func:`group_queries_by_set`); one launch answers the whole batch.
:func:`xam_search_multiset_sharded` is the fan-out over set shards that
the serving index's ``"fanout"`` oracle runs: one launch per shard that
holds queries, all on the planes' card.  The ``shard_map`` stacked search
spans several devices and is not ported (one card).
:func:`xam_search_multiset_device` is THE wrapper the serving path calls:
for tensors on the CPU it runs the plain PyTorch version
(``ref.xam_search_multiset_plain``), for CUDA tensors it launches the
Hopper kernel (``kernel.xam_search_multiset_cuda``) or raises — it never
falls back from the card to the plain version.  :func:`xam_search` (the
flat search behind ``core/api.py`` and ``dedup_mask``) dispatches the same
way through :func:`xam_search_device`.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels.common import bucket_pow2, resolve_plane_format
from repro_torch.kernels.xam_search import kernel
from repro_torch.kernels.xam_search.ref import (
    first_match, xam_search_multiset_plain, xam_search_plain)

#: Fused-search launches since import: :func:`xam_search_multiset_device`
#: adds one per call, where it launches the kernel (CUDA) or runs its
#: plain stand-in (CPU).  The serving index makes one call per lookup
#: batch, so this equals ``KVIndexStats.searches``.
LAUNCH_COUNT = 0

#: Flat-search launches since import: :func:`xam_search_device` adds one
#: per call (kernel on CUDA, plain version on the CPU).
FLAT_LAUNCH_COUNT = 0

#: Admission dispatches since import — ``MonarchKVIndex`` adds one per
#: ``admit_fps`` batch (the write-path twin of ``LAUNCH_COUNT``).
ADMIT_LAUNCH_COUNT = 0

_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to the module's launch count ``name``.  The HTTP edge's
    router workers search and admit from several threads, and ``+= 1`` on
    a module global is a read-modify-write that could lose a count."""
    with _COUNT_LOCK:
        globals()[name] += 1


#: Query-block width: the reference's cold autotune fallback (16 below
#: 256 queries, 64 at or above).  The answer never depends on it.
MULTISET_BLOCK_Q = 16
WIDE_BLOCK_AT = 256
WIDE_BLOCK_Q = 64


def _pick_block_q(n_queries: int, block_q: int | None) -> int:
    if block_q is not None:
        return block_q
    return WIDE_BLOCK_Q if n_queries >= WIDE_BLOCK_AT else MULTISET_BLOCK_Q


def _check_scoring(scoring: str) -> None:
    if scoring not in ("int8", "f32"):
        raise ValueError(
            f"scoring must be one of ('int8', 'f32'), got {scoring!r}")


# ---------------------------------------------------------------------------
# Host-side layouts.
# ---------------------------------------------------------------------------

def _group_one(set_ids: np.ndarray, n_sets: int, block_q: int):
    """Unbucketed per-set block packing: ``(slot, block_sets,
    total_blocks)`` with ``block_sets`` of exact length ``total_blocks``."""
    set_ids = np.asarray(set_ids, np.int64)
    q = set_ids.shape[0]
    counts = np.bincount(set_ids, minlength=n_sets)
    blocks_per_set = -(-counts // block_q)          # ceil
    total_blocks = int(blocks_per_set.sum())

    block_start = np.zeros(n_sets + 1, np.int64)
    np.cumsum(blocks_per_set, out=block_start[1:])
    set_start = np.zeros(n_sets + 1, np.int64)
    np.cumsum(counts, out=set_start[1:])

    order = np.argsort(set_ids, kind="stable")
    sorted_sets = set_ids[order]
    rank_in_set = np.arange(q, dtype=np.int64) - set_start[sorted_sets]
    slot = np.empty(q, np.int64)
    slot[order] = block_start[sorted_sets] * block_q + rank_in_set

    block_sets = np.repeat(
        np.arange(n_sets, dtype=np.int32), blocks_per_set)
    return slot, block_sets, total_blocks


def group_queries_by_set(set_ids: np.ndarray, n_sets: int,
                         block_q: int = MULTISET_BLOCK_Q):
    """Pack queries into per-set blocks of ``block_q`` and bucket the block
    count to a power of two.  Returns ``(slot, block_sets, padded_q,
    n_blocks)``: query i goes to padded row ``slot[i]``; block b searches
    set ``block_sets[b]``; only the first ``n_blocks`` blocks are live."""
    slot, block_sets, total_blocks = _group_one(set_ids, n_sets, block_q)
    n_qb = bucket_pow2(max(total_blocks, 1), lo=4)
    padded = np.zeros(n_qb, np.int32)
    padded[:total_blocks] = block_sets
    return slot, padded, n_qb * block_q, total_blocks


def group_queries_by_set_stacked(set_ids: np.ndarray, n_sets: int,
                                 n_parts: int,
                                 block_q: int = MULTISET_BLOCK_Q):
    """Two-level stacked layout: queries split by owning partition
    (``set_id // (n_sets // n_parts)``, contiguous blocks), then each
    partition's queries packed into per-(local-)set blocks as
    :func:`group_queries_by_set` packs them, every partition padded to one
    common pow2 block count.  Query i sits at row ``slot[i]`` of partition
    ``part_of[i]``; block b of partition p searches its local set
    ``block_sets[p, b]``; only its first ``n_blocks[p]`` blocks are live.
    Returns ``(part_of, slot, block_sets, n_blocks, padded_q)``.

    >>> part_of, slot, block_sets, n_blocks, padded_q = (
    ...     group_queries_by_set_stacked([5, 5, 4], 8, 2, block_q=4))
    >>> part_of.tolist(), slot.tolist()
    ([1, 1, 1], [4, 5, 0])
    >>> block_sets.tolist(), n_blocks.tolist(), padded_q
    ([[0, 0, 0, 0], [0, 1, 0, 0]], [0, 2], 16)
    """
    set_ids = np.asarray(set_ids, np.int64)
    if n_sets % n_parts != 0:
        raise ValueError(f"n_parts={n_parts} must divide n_sets={n_sets}")
    s_part = n_sets // n_parts
    part_of = set_ids // s_part
    grouped = []
    for p in range(n_parts):
        sel = np.nonzero(part_of == p)[0]
        sl, bs, tb = _group_one(set_ids[sel] - p * s_part, s_part, block_q)
        grouped.append((sel, sl, bs, tb))
    n_qb = bucket_pow2(max(max(g[3] for g in grouped), 1), lo=4)
    slot = np.empty(set_ids.shape[0], np.int64)
    block_sets = np.zeros((n_parts, n_qb), np.int32)
    n_blocks = np.zeros(n_parts, np.int32)
    for p, (sel, sl, bs, tb) in enumerate(grouped):
        slot[sel] = sl
        block_sets[p, :tb] = bs
        n_blocks[p] = tb
    return part_of, slot, block_sets, n_blocks, n_qb * block_q


def group_admits_stacked(set_ids: np.ndarray, n_sets: int, n_parts: int,
                         lo: int = 8):
    """Round-grid layout for batched admission.

    Candidate i gets ``part_of[i]`` (owning partition), ``row[i]`` (its
    per-set prefix rank: how many earlier candidates target the same
    set) and ``col[i]`` (its batch-order position among its partition's
    rank-``row[i]`` candidates).  Round r holds only rank-r candidates,
    whose sets are pairwise distinct, so a round admits vectorized while
    rounds replay intra-set collisions in batch order.  Both grid axes are
    pow2-bucketed.  Returns ``(part_of, row, col, n_rounds, round_width)``.

    >>> part_of, row, col, n_rounds, round_width = group_admits_stacked(
    ...     [5, 5, 4, 1], 8, 2)
    >>> part_of.tolist(), row.tolist(), col.tolist()
    ([1, 1, 1, 0], [0, 1, 0, 0], [0, 0, 1, 0])
    >>> n_rounds, round_width
    (2, 8)
    """
    set_ids = np.asarray(set_ids, np.int64)
    if n_sets % n_parts != 0:
        raise ValueError(f"n_parts={n_parts} must divide n_sets={n_sets}")
    s_part = n_sets // n_parts
    part_of = set_ids // s_part
    b = set_ids.shape[0]
    if b == 0:
        return part_of, set_ids.copy(), set_ids.copy(), 1, max(lo, 1)
    set_start = np.zeros(n_sets + 1, np.int64)
    np.cumsum(np.bincount(set_ids, minlength=n_sets), out=set_start[1:])
    order = np.argsort(set_ids, kind="stable")
    row = np.empty(b, np.int64)
    row[order] = np.arange(b) - set_start[set_ids[order]]
    n_rounds_real = int(row.max()) + 1
    gid = part_of * n_rounds_real + row
    g_start = np.zeros(n_parts * n_rounds_real + 1, np.int64)
    np.cumsum(np.bincount(gid, minlength=n_parts * n_rounds_real),
              out=g_start[1:])
    gorder = np.argsort(gid, kind="stable")
    col = np.empty(b, np.int64)
    col[gorder] = np.arange(b) - g_start[gid[gorder]]
    n_rounds = bucket_pow2(n_rounds_real, lo=1)
    round_width = bucket_pow2(int(col.max()) + 1, lo=lo)
    return part_of, row, col, n_rounds, round_width


def pack_multiset_batch(key_bits: np.ndarray, set_ids: np.ndarray,
                        n_sets: int, block_q: int):
    """The launch layout of one search: ``(keys, masks, block_sets, live,
    slot)``.  Query i's key sits at padded row ``slot[i]`` with every bit
    masked in; pad rows keep an all-zero mask (a miss); ``live`` is 1 for
    the first ``n_blocks`` blocks and 0 for the pow2 bucket's tail."""
    key_bits = np.asarray(key_bits, np.int8)
    slot, block_sets, padded_q, n_blocks = group_queries_by_set(
        set_ids, n_sets, block_q)
    keys = np.zeros((padded_q, key_bits.shape[1]), np.int8)
    masks = np.zeros_like(keys)
    keys[slot] = key_bits
    masks[slot] = 1
    live = (np.arange(len(block_sets)) < n_blocks).astype(np.int32)
    return keys, masks, block_sets, live, slot


def words_to_bits_np(words: np.ndarray, n_bits: int = 32) -> np.ndarray:
    """(...,) uint words -> (..., n_bits) int8 bit planes (LSB first).

    >>> words_to_bits_np(np.asarray([5], np.uint32), 4).tolist()
    [[1, 0, 1, 0]]
    """
    words = np.asarray(words)
    if n_bits > np.iinfo(words.dtype).bits:
        raise ValueError("n_bits exceeds word width")
    shifts = np.arange(n_bits, dtype=words.dtype)
    return ((words[..., None] >> shifts) & 1).astype(np.int8)


# ---------------------------------------------------------------------------
# The wrapper and the serving entry point.
# ---------------------------------------------------------------------------

def _check_operands(keys, masks, planes, valid, block_sets, live_blocks,
                    block_q: int) -> None:
    if keys.dtype != torch.int8 or masks.dtype != torch.int8:
        raise TypeError(f"keys/masks must be int8, got {keys.dtype}/"
                        f"{masks.dtype}")
    if planes.dtype not in (torch.int8, torch.uint8):
        raise TypeError("planes must be int8 (unpacked) or uint8 (packed8), "
                        f"got {planes.dtype}")
    if valid.dtype != torch.int8:
        raise TypeError(f"valid must be int8, got {valid.dtype}")
    if block_sets.dtype != torch.int32 or live_blocks.dtype != torch.int32:
        raise TypeError("block_sets/live_blocks must be int32")
    q, r = keys.shape
    n_sets, rp, c = planes.shape
    if planes.dtype == torch.uint8 and r != rp * 8:
        raise ValueError(
            f"packed planes hold {rp * 8} bit rows but keys have {r}; "
            "plane_format='packed8' needs key bits padded to a multiple "
            "of 8")
    if planes.dtype == torch.int8 and r != rp:
        raise ValueError(f"planes hold {rp} bit rows but keys have {r}")
    if masks.shape != keys.shape or valid.shape != (n_sets, c):
        raise ValueError(f"shape mismatch: keys {tuple(keys.shape)}, masks "
                         f"{tuple(masks.shape)}, valid {tuple(valid.shape)}")
    if q % block_q != 0 or block_sets.shape != (q // block_q,) or \
            live_blocks.shape != (q // block_q,):
        raise ValueError(f"Q={q} must be a multiple of block_q={block_q} "
                         "with one block_sets/live_blocks entry per block")


def xam_search_multiset_device(keys: torch.Tensor, masks: torch.Tensor,
                               planes: torch.Tensor, valid: torch.Tensor,
                               block_sets: torch.Tensor,
                               live_blocks: torch.Tensor, *, block_q: int,
                               scoring: str = "int8") -> torch.Tensor:
    """One fused search over a set-grouped padded batch.

    keys/masks (Q, R) int8 with Q a multiple of ``block_q``; planes
    (n_sets, R, C) int8 or (n_sets, R/8, C) uint8 packed words; valid
    (n_sets, C) int8; block_sets/live_blocks (Q/block_q,) int32.  Returns
    (Q,) int32: first valid matching way, -1 = miss (dead blocks and
    all-zero mask rows included).  ``scoring`` ("int8"/"f32") is validated
    for parity with the reference, whose two scorings are bit-identical;
    the exact compare serves both.  CPU tensors run the plain version,
    CUDA tensors the kernel (launched on the current stream, not
    synchronised)."""
    _check_scoring(scoring)
    _check_operands(keys, masks, planes, valid, block_sets, live_blocks,
                    block_q)
    if planes.device.type == "cpu":
        count_launch("LAUNCH_COUNT")
        return xam_search_multiset_plain(keys, masks, planes, valid,
                                         block_sets, live_blocks,
                                         block_q=block_q)
    if planes.device.type == "cuda":
        out = kernel.xam_search_multiset_cuda(
            keys, masks, planes, valid, block_sets, live_blocks,
            block_q=block_q)
        count_launch("LAUNCH_COUNT")
        return out
    raise ValueError(f"unsupported device {planes.device}")


def xam_search_multiset(key_bits: np.ndarray, set_ids: np.ndarray,
                        planes: torch.Tensor, valid: torch.Tensor, *,
                        block_q: int | None = None,
                        scoring: str = "int8") -> np.ndarray:
    """Batched CAM search across sets in ONE launch.

    ``key_bits`` (Q, R) {0,1} host rows, ``set_ids`` (Q,) in ``[0,
    n_sets)``, ``planes``/``valid`` the device-resident index planes.
    Returns the (Q,) int32 first matching valid way per query (-1 =
    miss) on the host — the one synchronisation of a lookup."""
    out, slot = _multiset_dispatch(key_bits, set_ids, planes, valid,
                                   block_q=block_q, scoring=scoring)
    return out.cpu().numpy()[slot]


def _multiset_dispatch(key_bits, set_ids, planes, valid, *, block_q,
                       scoring):
    """Pack and launch one search without waiting for it: returns the
    padded (Q',) device result and each query's row in it."""
    key_bits = np.asarray(key_bits, np.int8)
    set_ids = np.asarray(set_ids, np.int64)
    n_sets = planes.shape[0]
    if set_ids.size and (set_ids.min() < 0 or set_ids.max() >= n_sets):
        raise ValueError(f"set ids must lie in [0, {n_sets})")
    block_q = _pick_block_q(len(set_ids), block_q)
    keys, masks, block_sets, live, slot = pack_multiset_batch(
        key_bits, set_ids, n_sets, block_q)
    put = lambda x: torch.from_numpy(x).to(planes.device)
    out = xam_search_multiset_device(
        put(keys), put(masks), planes, valid, put(block_sets),
        put(live), block_q=block_q, scoring=scoring)
    return out, slot


def xam_search_multiset_sharded(key_bits: np.ndarray, set_ids: np.ndarray,
                                planes_by_shard, valid_by_shard, *,
                                block_q: int | None = None,
                                scoring: str = "int8") -> np.ndarray:
    """Fan a query batch out over set-sharded planes: queries split by
    owning shard (``set_id // sets_per_shard``), then one shard-local
    :func:`xam_search_multiset_device` launch per shard that holds
    queries, against that shard's ``(sets_per_shard, R, C)`` planes.
    Every launch is made before any result is read back.  Returns the
    (Q,) int32 set-local first matching way, -1 = miss; with one shard
    this is exactly :func:`xam_search_multiset`."""
    if len(planes_by_shard) == 1:
        return xam_search_multiset(key_bits, set_ids, planes_by_shard[0],
                                   valid_by_shard[0], block_q=block_q,
                                   scoring=scoring)
    key_bits = np.asarray(key_bits, np.int8)
    set_ids = np.asarray(set_ids, np.int64)
    s_local = planes_by_shard[0].shape[0]
    shard_ids = set_ids // s_local
    pending = []
    for k in np.unique(shard_ids):
        sel = np.nonzero(shard_ids == k)[0]
        out, slot = _multiset_dispatch(
            key_bits[sel], set_ids[sel] - int(k) * s_local,
            planes_by_shard[int(k)], valid_by_shard[int(k)],
            block_q=block_q, scoring=scoring)
        pending.append((sel, slot, out))
    ways = np.empty(set_ids.shape[0], np.int32)
    for sel, slot, out in pending:
        ways[sel] = out.cpu().numpy()[slot]
    return ways


# ---------------------------------------------------------------------------
# The flat search (Fig. 6 API, dedup).
# ---------------------------------------------------------------------------

def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """(R, C) {0,1} bits -> (ceil(R/8), C) uint8 words, LSB-first along R,
    zero rows padding R to a multiple of 8 (the layout of
    ``common.pack_bits_np(..., axis=0)``), on the bits' device."""
    r, c = bits.shape
    rp = -(-r // 8)
    padded = torch.zeros((rp * 8, c), dtype=torch.int32, device=bits.device)
    padded[:r] = bits
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (padded.reshape(rp, 8, c) << shifts[:, None]).sum(dim=1).to(
        torch.uint8)


def xam_search_device(keys: torch.Tensor, data: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """One flat search over tensors on one device: keys/masks (Q, R) int8,
    data (R, C) int8 or (Rp, C) uint8 packed words with ``Rp * 8 >= R``.
    Returns the (Q, C) int8 bitmap; an all-zero mask row matches every
    column.  CPU tensors run the plain version, CUDA tensors the kernel
    (on the current stream, not synchronised)."""
    if keys.dtype != torch.int8 or masks.dtype != torch.int8:
        raise TypeError(f"keys/masks must be int8, got {keys.dtype}/"
                        f"{masks.dtype}")
    if data.dtype not in (torch.int8, torch.uint8) or data.dim() != 2:
        raise TypeError("data must be a 2-D int8 (unpacked) or uint8 "
                        f"(packed8) plane, got {data.dtype} "
                        f"{tuple(data.shape)}")
    q, r = keys.shape
    rows = data.shape[0] * (8 if data.dtype == torch.uint8 else 1)
    if masks.shape != keys.shape or (
            rows != r if data.dtype == torch.int8 else rows < r):
        raise ValueError(f"shape mismatch: keys {tuple(keys.shape)}, masks "
                         f"{tuple(masks.shape)}, data {tuple(data.shape)} "
                         f"({data.dtype})")
    if data.device.type == "cpu":
        count_launch("FLAT_LAUNCH_COUNT")
        return xam_search_plain(keys, data, masks)
    if data.device.type == "cuda":
        out = kernel.xam_search_cuda(keys.contiguous(), data.contiguous(),
                                     masks.contiguous())
        count_launch("FLAT_LAUNCH_COUNT")
        return out
    raise ValueError(f"unsupported device {data.device}")


def xam_search(keys, data: torch.Tensor, masks=None, *,
               scoring: str = "int8",
               plane_format: str | None = None) -> torch.Tensor:
    """Masked CAM search: (Q, R) keys x (R, C) stored bits -> (Q, C) int8
    matches, on ``data``'s device (keys and masks, tensors or arrays, are
    moved there).  ``masks=None`` selects every bit.

    ``plane_format`` (None = the ``REPRO_PLANE_FORMAT`` env knob, default
    ``"int8"``): ``"packed8"`` packs ``data`` 8 rows per uint8 word (R
    padded to a multiple of 8 with zero rows, which the keys' mask never
    selects) before the search — bit-identical results.  ``scoring``
    ("int8"/"f32") is validated for parity with the reference, whose two
    scorings are bit-identical; the exact compare serves both."""
    _check_scoring(scoring)
    plane_format = resolve_plane_format(plane_format)
    dev = data.device
    keys = torch.as_tensor(keys, device=dev).to(torch.int8)
    masks = (torch.ones_like(keys) if masks is None
             else torch.as_tensor(masks, device=dev).to(torch.int8))
    data = data.to(torch.int8)
    if plane_format == "packed8":
        data = pack_rows(data)
    return xam_search_device(keys, data, masks)


def xam_match_index(keys, data: torch.Tensor, masks=None,
                    **kw) -> torch.Tensor:
    """First matching column per query; -1 = NULL match register."""
    return first_match(xam_search(keys, data, masks, **kw))


def words_to_bits(words: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """(...,) uint32 values (held in int64) -> (..., n_bits) int8 bit
    planes, LSB first."""
    if n_bits > 32:
        raise ValueError("n_bits exceeds word width")
    shifts = torch.arange(n_bits, dtype=torch.int64, device=words.device)
    return ((words.to(torch.int64)[..., None] >> shifts) & 1).to(torch.int8)


def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., n_bits) {0,1} bits -> (...,) int64 words (LSB first)."""
    shifts = torch.arange(bits.shape[-1], dtype=torch.int64,
                          device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(dim=-1)
