"""Wrappers for the hopscotch window lookup and the device-resident
insert/delete path (port of ``repro/kernels/hopscotch/ops.py``).

Key and value planes are (N,) int32 tensors holding uint32 bit patterns
(torch's uint32 support is partial).  :func:`hopscotch_lookup_device`
picks by the table's device: a CPU tensor runs the plain version
(``ref.hopscotch_lookup_plain``), a CUDA tensor launches the Hopper kernel
(``kernel.hopscotch_lookup_cuda``) or raises.

The insert runs as torch ops on the planes' device with a host loop over
the hop chain (one synchronisation for the decision, one per hop); it
updates the planes IN PLACE where the reference donates them and returns
new ones.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.pipeline import murmur3_fmix32
from repro_torch.kernels.common import bucket_pow2
from repro_torch.kernels.hopscotch import kernel
from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain

#: Query rows per pow2 bucket floor (the reference kernel's block_q).
BLOCK_Q = 8

#: Lookup launches since import: :func:`hopscotch_lookup_device` adds one
#: per call, where it launches the kernel (CUDA) or runs its plain version
#: (CPU).
LAUNCH_COUNT = 0


def as_i32_bits(words) -> np.ndarray:
    """uint32 values (any integer array or tensor) -> their int32 bit
    patterns, on the host."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.asarray(words)
    if words.dtype == np.int32:
        return words
    return (words.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def _s32(x: int) -> int:
    """A uint32 value as its int32 bit pattern."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def hopscotch_lookup_device(table_lo: torch.Tensor, table_hi: torch.Tensor,
                            homes: torch.Tensor, q_lo: torch.Tensor,
                            q_hi: torch.Tensor, *,
                            window: int) -> torch.Tensor:
    """One window probe over int32 tensors on one device: table_lo/hi
    (N,), homes/q_lo/q_hi (Q,).  Returns (Q,) int32 first-match offsets
    (-1 = miss).  CUDA tensors launch the kernel on the current stream
    (not synchronised)."""
    global LAUNCH_COUNT
    ops_ = (table_lo, table_hi, homes, q_lo, q_hi)
    if any(t.dtype != torch.int32 for t in ops_):
        raise TypeError("hopscotch operands must be int32 (uint32 keys as "
                        f"bit patterns); got {[t.dtype for t in ops_]}")
    if table_hi.shape != table_lo.shape or not (
            homes.shape == q_lo.shape == q_hi.shape):
        raise ValueError("table_lo/table_hi and homes/q_lo/q_hi must have "
                         "matching shapes")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if table_lo.device.type == "cpu":
        LAUNCH_COUNT += 1
        return hopscotch_lookup_plain(*ops_, window)
    if table_lo.device.type == "cuda":
        out = kernel.hopscotch_lookup_cuda(*ops_, window=window)
        LAUNCH_COUNT += 1
        return out
    raise ValueError(f"unsupported device {table_lo.device}")


def hopscotch_lookup(table_lo: torch.Tensor, table_hi: torch.Tensor, homes,
                     q_lo, q_hi, *, window: int) -> torch.Tensor:
    """Batched hopscotch window probe of host queries.

    ``table_lo``/``table_hi``: (N,) int32 planes on the device (0/0 =
    EMPTY).  ``homes`` (Q,) home slots; ``q_lo``/``q_hi`` (Q,) uint32
    query halves (any integer arrays).  The query count is bucketed to a
    power of two (floor ``BLOCK_Q``) as in the reference; the pad rows
    carry home 0 and key 0, which matches EMPTY slots, and are sliced off.
    Returns (Q,) int32 offsets on the table's device."""
    homes = np.asarray(homes, np.int64)
    q = homes.shape[0]
    qv = np.zeros((3, bucket_pow2(q, BLOCK_Q)), np.int32)
    qv[0, :q] = homes
    qv[1, :q] = as_i32_bits(q_lo)
    qv[2, :q] = as_i32_bits(q_hi)
    qv = torch.from_numpy(qv).to(table_lo.device)
    out = hopscotch_lookup_device(table_lo, table_hi, qv[0], qv[1], qv[2],
                                  window=window)
    return out[:q]


# ---------------------------------------------------------------------------
# Device-resident mutation path (apps/hashtable.py "device" backend).
# ---------------------------------------------------------------------------

def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D mask, -1 when none (0-d int64)."""
    return torch.where(mask.any(), mask.to(torch.int32).argmax(), -1)


def hopscotch_insert_device(k_lo: torch.Tensor, k_hi: torch.Tensor,
                            v_lo: torch.Tensor, v_hi: torch.Tensor,
                            home: int, q_lo: int, q_hi: int, nv_lo: int,
                            nv_hi: int, *, window: int):
    """One hopscotch insert on the device-resident planes, in place.

    Bit-for-bit replica of ``HopscotchTable.insert``'s host algorithm over
    the split key/value planes (length ``n + 2*window``; 0/0 = EMPTY):
    resident-key value update, first-free-window install, else the forward
    walk to the first free bucket (capped at ``min(n + w, home + 64w)``)
    and the hop chain back into the window — each hop moves the FIRST
    window-compatible key forward (its home recomputed from its low word
    with murmur3), and a failed chain leaves its partial moves in place
    for the rehash.  A moved key's value stays behind at its old slot as
    a stale copy, as in the host algorithm.  Key and value halves are
    uint32 values (Python ints).

    Returns ``(status, probes, swaps, log)``: ``status`` 0 = resident value
    update, 1 = installed, 2 = needs rehash; ``probes`` the
    ``insert_probes`` delta; ``swaps`` the hop count; ``log`` the touched
    bucket indices in the host's ``_record_write`` order (j, k per hop,
    then the final slot)."""
    w = int(window)
    n = k_lo.shape[0] - 2 * w
    h = int(home)
    ql, qh = _s32(q_lo), _s32(q_hi)
    limit = min(n + w, h + 64 * w)

    # One read-back decides the path: resident offset, first free offset
    # in the window, first free bucket of the forward walk.
    seg_lo, seg_hi = k_lo[h:limit], k_hi[h:limit]
    empty = (seg_lo == 0) & (seg_hi == 0)
    res_off, free_off, fwd_off = torch.stack([
        _first((seg_lo[:w] == ql) & (seg_hi[:w] == qh)),
        _first(empty[:w]), _first(empty[w:])]).tolist()

    log: list[int] = []
    if res_off >= 0:
        slot = h + res_off
        v_lo[slot], v_hi[slot] = _s32(nv_lo), _s32(nv_hi)
        return 0, 0, 0, [slot]
    if free_off >= 0:
        slot = h + free_off
        k_lo[slot], k_hi[slot] = ql, qh
        v_lo[slot], v_hi[slot] = _s32(nv_lo), _s32(nv_hi)
        return 1, free_off + 1, 0, [slot]
    if fwd_off < 0:                      # no free bucket: rehash
        return 2, w + (limit - (h + w)), 0, log
    j = h + w + fwd_off
    probes = w + fwd_off
    while j >= h + w:
        if w == 1:                       # no hop candidates exist
            return 2, probes, 0, log
        c_lo, c_hi = k_lo[j - w + 1:j], k_hi[j - w + 1:j]
        homes_k = murmur3_fmix32(c_lo) % n
        movable = ((c_lo != 0) | (c_hi != 0)) & (homes_k + w > j)
        first = int(_first(movable))
        if first < 0:                    # failed chain: partial moves stay
            return 2, probes, len(log) // 2, log
        k = j - w + 1 + first
        for plane in (k_lo, k_hi, v_lo, v_hi):
            plane[j] = plane[k]
        k_lo[k], k_hi[k] = 0, 0
        log += [j, k]
        j = k
    k_lo[j], k_hi[j] = ql, qh
    v_lo[j], v_hi[j] = _s32(nv_lo), _s32(nv_hi)
    log.append(j)
    return 1, probes, (len(log) - 1) // 2, log


def hopscotch_delete_device(k_lo: torch.Tensor, k_hi: torch.Tensor,
                            v_lo: torch.Tensor, v_hi: torch.Tensor,
                            idx: int) -> None:
    """Clear one resolved bucket (key AND value planes) in place."""
    for plane in (k_lo, k_hi, v_lo, v_hi):
        plane[int(idx)] = 0
