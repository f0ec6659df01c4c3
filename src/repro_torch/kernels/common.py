"""Helpers shared by the kernel packages (port of ``repro/kernels/common.py``).

Plane storage formats: ``"int8"`` keeps one logical bit per int8 byte;
``"packed8"`` packs 8 logical bits per uint8 word along the bit axis
(LSB-first), so a kernel reads ~8x fewer plane bytes and unpacks on chip.
The tensor dtype is the format tag: int8 planes are unpacked, uint8 planes
are packed words.
"""
from __future__ import annotations

import os

import numpy as np
import torch

PLANE_FORMATS = ("int8", "packed8")

#: Env knob that picks the default plane format.
PLANE_FORMAT_ENV = "REPRO_PLANE_FORMAT"


def bucket_pow2(n: int, lo: int) -> int:
    """Next power of two >= max(n, lo) — bounds the number of distinct
    padded shapes ragged batches produce."""
    b = lo
    while b < n:
        b <<= 1
    return b


def resolve_plane_format(fmt: str | None = None) -> str:
    """Validate a plane format; ``None`` reads the ``REPRO_PLANE_FORMAT``
    env knob (default ``"int8"``).  Raises ``ValueError`` naming the knob
    and the valid values."""
    if fmt is None:
        fmt = os.environ.get(PLANE_FORMAT_ENV, "int8")
    if fmt not in PLANE_FORMATS:
        raise ValueError(
            f"plane_format must be one of {PLANE_FORMATS}, got {fmt!r} "
            f"(set via the {PLANE_FORMAT_ENV} env knob or the plane_format "
            "argument)")
    return fmt


def plane_format_of(planes) -> str:
    """Storage format of a stored-bit plane tensor from its dtype: uint8
    planes hold packed words, int8 planes one bit per byte."""
    dt = planes.dtype
    if dt == torch.uint8:
        return "packed8"
    if dt == torch.int8:
        return "int8"
    raise ValueError(
        f"stored-bit planes must be int8 (unpacked) or uint8 (packed8); "
        f"got dtype {dt}")


def pack_bits_np(bits: np.ndarray, axis: int = -1) -> np.ndarray:
    """Pack {0,1} bit planes 8-per-uint8-word along ``axis``, LSB-first.

    The layout contract (shared with the in-kernel unpack and
    ``words_to_bits``): logical bit ``r`` of a column lives in packed
    word ``r // 8`` at bit position ``r % 8``.  The bit-axis length must
    be a multiple of 8 — pad with zero bits first if it is not (all-zero
    mask rows are inert in the search).

    >>> pack_bits_np(np.asarray([[1, 0, 1, 0, 0, 0, 0, 0]], np.int8)
    ...              ).tolist()
    [[5]]
    >>> cols = np.asarray([[1, 1, 0, 0, 0, 0, 0, 1] * 2], np.int8)
    >>> unpack_bits_np(pack_bits_np(cols), 16).tolist() == cols.tolist()
    True
    """
    bits = np.asarray(bits)
    axis = axis % bits.ndim
    r = bits.shape[axis]
    if r % 8 != 0:
        raise ValueError(
            f"bit-axis length {r} is not a multiple of 8; pad with zero "
            "bits before packing (plane_format='packed8' stores 8 bits "
            "per uint8 word)")
    moved = np.moveaxis(bits, axis, -1).astype(np.uint8)
    words = moved.reshape(moved.shape[:-1] + (r // 8, 8))
    shifts = np.arange(8, dtype=np.uint8)
    packed = np.bitwise_or.reduce(words << shifts, axis=-1).astype(np.uint8)
    return np.moveaxis(packed, -1, axis)


def unpack_bits_np(packed: np.ndarray, n_bits: int | None = None,
                   axis: int = -1) -> np.ndarray:
    """Inverse of :func:`pack_bits_np`: uint8 packed words -> {0,1} int8
    bit planes along ``axis`` (LSB-first).  ``n_bits`` trims the unpacked
    axis (default: 8x the packed length)."""
    packed = np.asarray(packed, np.uint8)
    axis = axis % packed.ndim
    moved = np.moveaxis(packed, axis, -1)
    shifts = np.arange(8, dtype=np.uint8)
    bits = ((moved[..., None] >> shifts) & 1).astype(np.int8)
    bits = bits.reshape(moved.shape[:-1] + (moved.shape[-1] * 8,))
    if n_bits is not None:
        bits = bits[..., :n_bits]
    return np.moveaxis(bits, -1, axis)
