"""Bit-accurate functional model of the XAM reconfigurable RAM/CAM array
(paper §4) — port of ``repro/core/xam.py`` over torch tensors.

Each cell of the crosspoint stores one bit as a differential (R, R̄)
resistance pair.  The array supports four data-plane operations:

* ``write_row``    — two-step row write (0s first, then 1s), §4.1.1
* ``write_col``    — two-step column write, §4.1.2 (enabled by the 2R cell)
* ``read_row``     — voltage-divider row read against Ref_R, §4.2.1
* ``search``       — masked parallel match of a key against ALL columns
                     (in-situ XNOR + analog column sum vs Ref_S), §4.2.2

Everything is pure-functional over {0,1} int8 bit planes.  Wear model:
every cell on an active row/column receives a programming pulse on each
write regardless of whether its value changes (constant write voltage).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

# Canonical XAM array geometry (paper §6 / Table 3): 64 x 64 bit subarrays.
N_ROWS = 64
N_COLS = 64


@dataclasses.dataclass(frozen=True)
class XamArray:
    """State of one XAM subarray.

    bits        : (n_rows, n_cols) int8 in {0,1} — logical cell contents.
    cell_writes : (n_rows, n_cols) int32 — cumulative programming pulses.
    """

    bits: torch.Tensor
    cell_writes: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.bits.shape[0]

    @property
    def n_cols(self) -> int:
        return self.bits.shape[1]


def make_array(n_rows: int = N_ROWS, n_cols: int = N_COLS,
               device: str | torch.device = "cuda") -> XamArray:
    device = resolve_device(device)
    return XamArray(
        bits=torch.zeros((n_rows, n_cols), dtype=torch.int8, device=device),
        cell_writes=torch.zeros((n_rows, n_cols), dtype=torch.int32,
                                device=device),
    )


def _onehot(n: int, i, like: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(n, device=like.device)
    return (idx == torch.as_tensor(i, device=like.device)).to(torch.int8)


# Writes (two-step: 0s then 1s).  Step 1 touches exactly the cells
# receiving a 0, step 2 exactly the cells receiving a 1; cells on inactive
# lines are never disturbed (V/2 half-select).

def write_row_steps(arr: XamArray, row, data):
    """``(new_array, step0_mask, step1_mask)`` for writing ``data`` (n_cols,)
    bits into row ``row``."""
    data = torch.as_tensor(data, device=arr.bits.device).to(torch.int8)
    row_onehot = _onehot(arr.n_rows, row, arr.bits)                 # (R,)
    step0 = row_onehot[:, None] * (1 - data)[None, :]
    step1 = row_onehot[:, None] * data[None, :]
    new_bits = torch.where(row_onehot[:, None] == 1, data[None, :], arr.bits)
    new_wear = arr.cell_writes + row_onehot[:, None].to(torch.int32)
    return XamArray(new_bits.to(torch.int8), new_wear), step0, step1


def write_row(arr: XamArray, row, data) -> XamArray:
    return write_row_steps(arr, row, data)[0]


def write_col_steps(arr: XamArray, col, data):
    """Column write (§4.1.2): data fed through the ROW drivers, one column
    active, the others half-selected.  data: (n_rows,) bits."""
    data = torch.as_tensor(data, device=arr.bits.device).to(torch.int8)
    col_onehot = _onehot(arr.n_cols, col, arr.bits)                 # (C,)
    step0 = (1 - data)[:, None] * col_onehot[None, :]
    step1 = data[:, None] * col_onehot[None, :]
    new_bits = torch.where(col_onehot[None, :] == 1, data[:, None], arr.bits)
    new_wear = arr.cell_writes + col_onehot[None, :].to(torch.int32)
    return XamArray(new_bits.to(torch.int8), new_wear), step0, step1


def write_col(arr: XamArray, col, data) -> XamArray:
    return write_col_steps(arr, col, data)[0]


# Reads and searches.

def read_row(arr: XamArray, row) -> torch.Tensor:
    """Row read (§4.2.1): sensing the divider against Ref_R = V_R/2
    recovers the stored bits of ``row``."""
    return arr.bits[torch.as_tensor(row, device=arr.bits.device).long()]


def search_voltages(bits: torch.Tensor, key, mask) -> torch.Tensor:
    """Analog model of the CAM search (§4.2.2): the normalized column line
    voltage ``1 - mismatches / selected`` in float32, as the reference."""
    key = torch.as_tensor(key, device=bits.device).to(torch.int8)
    mask = torch.as_tensor(mask, device=bits.device).to(torch.int8)
    xnor = (bits == key[:, None]).to(torch.int32)
    mism = (mask[:, None].to(torch.int32) * (1 - xnor)).sum(0)
    n_sel = torch.clamp(mask.to(torch.int32).sum(), min=1)
    return 1.0 - mism.to(torch.float32) / n_sel.to(torch.float32)


def ref_s(n_selected) -> torch.Tensor:
    """Sensing reference between all-match (1.0) and single-mismatch
    (1 - 1/n) normalized voltages."""
    n = torch.clamp(torch.as_tensor(n_selected), min=1).to(torch.float32)
    return 1.0 - 0.5 / n


def search(arr: XamArray, key, mask) -> torch.Tensor:
    """Masked parallel search; key, mask (n_rows,) bits.  Returns the
    (n_cols,) int8 match vector: 1 iff every unmasked key bit equals the
    stored column bit."""
    v = search_voltages(arr.bits, key, mask)
    mask = torch.as_tensor(mask, device=arr.bits.device)
    n_sel = mask.to(torch.int32).sum()
    return (v > ref_s(n_sel)).to(torch.int8)


def search_digital(arr: XamArray, key, mask) -> torch.Tensor:
    """Digital oracle for :func:`search` (no analog model)."""
    key = torch.as_tensor(key, device=arr.bits.device).to(torch.int8)
    mask = torch.as_tensor(mask, device=arr.bits.device).to(torch.int8)
    eq = (arr.bits == key[:, None]) | (mask[:, None] == 0)
    return eq.all(0).to(torch.int8)


# Set-level helpers.  One Monarch set spans 8 diagonal subarrays of a
# superset: a logical 64-row x 512-column plane.  Blocks are written
# row-wise across the 8 subarrays; tags/keys column-wise.

SET_COLS = 8 * N_COLS  # 512 columns searchable in one command


def make_set(n_rows: int = N_ROWS, n_cols: int = SET_COLS,
             device: str | torch.device = "cuda") -> XamArray:
    return make_array(n_rows, n_cols, device)


def set_search(arr: XamArray, key, mask):
    """Search a whole set: ``(match_vector, match_index)``, the index the
    lowest matching column or -1 (the match register resets to NULL)."""
    matches = search(arr, key, mask)
    any_match = (matches == 1).any()
    idx = torch.argmax(matches)          # first maximum: lowest 1
    return matches, torch.where(any_match, idx, -1).to(torch.int32)


def pack_block_rowwise(arr: XamArray, row, block_bits) -> XamArray:
    """Write one 512-bit block across a set's row (RowIn RAM mode)."""
    return write_row(arr, row, block_bits)


def store_key_colwise(arr: XamArray, col, key_bits) -> XamArray:
    """Store a key/tag down a column (ColumnIn CAM mode)."""
    return write_col(arr, col, key_bits)


# Packed plane views: logical row ``r`` lands in packed word ``r // 8`` at
# bit ``r % 8`` (LSB-first), the serving kernels' ``packed8`` layout.

def packed_view(bits: torch.Tensor) -> torch.Tensor:
    """Row-packed (R//8, C) uint8 view of a {0,1} (R, C) bit plane; R must
    be a multiple of 8.

    >>> import torch
    >>> plane = torch.zeros((8, 2), dtype=torch.int8)
    >>> plane[0, 0] = plane[2, 0] = 1
    >>> packed_view(plane).tolist()   # bit0 + bit2 = 5
    [[5, 0]]
    >>> bool((unpacked_view(packed_view(plane)) == plane).all())
    True
    """
    r, c = bits.shape
    if r % 8 != 0:
        raise ValueError(
            f"row count {r} is not a multiple of 8; pad with zero rows "
            "before packing")
    words = bits.to(torch.uint8).reshape(r // 8, 8, c)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (words << shifts[None, :, None]).sum(1).to(torch.uint8)


def unpacked_view(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`packed_view`: (R//8, C) uint8 words back to the
    (R, C) int8 bit plane."""
    rp, c = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(rp * 8, c).to(torch.int8)
