"""User-space Monarch API (paper §7 "OS Support", Fig. 6) — port of
``repro/core/api.py``.

Mirrors the memkind-extension programming model: ``flat_ram_malloc`` /
``flat_cam_malloc`` allocate from vault-backed RAM/CAM address spaces, and
the :class:`MonarchDevice` exposes the key / mask / match registers that
the vault controller maps onto ordinary loads and stores.  The data-plane
search is the flat XAM search (a Hopper kernel on the card); the control
plane (lazy key/mask push, fresh match-register reuse) follows the
reference, command for command, in ``command_log``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.xam_search import ops as xam_ops

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class Allocation:
    base: int
    n_elems: int
    space: str  # "ram" | "cam"


class MonarchDevice:
    """An 8-vault Monarch stack with per-vault mode configuration.

    Vaults configured "cache" are hardware-managed and invisible here; the
    flat vaults expose scratchpad address spaces: one flat-RAM region and
    one flat-CAM region (sets of ``key_bits``-bit words stored column-wise,
    ``set_cols`` columns per set).  Everything lives on ``device``
    (default ``"cuda"``; raises without a card): the CAM planes as
    (n_sets, key_bits, set_cols) int8 bits, the RAM words as int64 holding
    uint32 values, and the key/mask registers as int8 bits.
    """

    def __init__(self, n_sets: int = 64, key_bits: int = 64,
                 set_cols: int = 512, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.key_bits = key_bits
        self.set_cols = set_cols
        self.n_sets = n_sets
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        self.cam_bits = z((n_sets, key_bits, set_cols), torch.int8)
        self.ram = z((n_sets * set_cols,), torch.int64)
        self.ram_hi = z((n_sets * set_cols,), torch.int64)
        # Vault-controller registers.
        self.key_reg = z((key_bits,), torch.int8)
        self.mask_reg = torch.ones((key_bits,), dtype=torch.int8,
                                   device=self.device)
        self.match_reg = -1
        self._match_fresh = False
        self._km_pushed = set()  # supersets holding the latest key/mask
        self._ram_ptr = 0
        self._cam_ptr = 0
        self.command_log: list[str] = []

    # ---- memkind-style allocation ------------------------------------
    def flat_ram_malloc(self, n_elems: int) -> Allocation:
        a = Allocation(self._ram_ptr, n_elems, "ram")
        self._ram_ptr += n_elems
        if self._ram_ptr > self.ram.shape[0]:
            raise MemoryError("flat-RAM vault exhausted")
        return a

    def flat_cam_malloc(self, n_elems: int) -> Allocation:
        a = Allocation(self._cam_ptr, n_elems, "cam")
        self._cam_ptr += n_elems
        if self._cam_ptr > self.n_sets * self.set_cols:
            raise MemoryError("flat-CAM vault exhausted")
        return a

    # ---- data plane ----------------------------------------------------
    def _to_bits(self, word: int, n: int) -> torch.Tensor:
        """Bits 0..n-1 of a Python int (any width, negatives as two's
        complement), built on the host: keys of 2**63 and above do not
        fit torch's int64."""
        bits = np.asarray([(int(word) >> i) & 1 for i in range(n)], np.int8)
        return torch.from_numpy(bits).to(self.device)

    def cam_write(self, alloc: Allocation, index: int, key: int) -> None:
        """Fig. 6: myDATA-style write — store ``key`` column-wise in CAM.
        Updates the CAM plane in place (the reference builds a new one)."""
        pos = alloc.base + index
        set_id, col = divmod(pos, self.set_cols)
        self.cam_bits[set_id, :, col] = self._to_bits(key, self.key_bits)
        self._match_fresh = False
        self.command_log.append(f"W cam set={set_id} col={col}")

    def ram_write(self, alloc: Allocation, index: int, value: int) -> None:
        pos = alloc.base + index
        self.ram[pos] = value & _U32
        self.ram_hi[pos] = (value >> 32) & _U32
        self.command_log.append(f"W ram {pos}")

    def ram_read(self, alloc: Allocation, index: int) -> int:
        pos = alloc.base + index
        self.command_log.append(f"R ram {pos}")
        lo, hi = torch.stack([self.ram[pos], self.ram_hi[pos]]).tolist()
        return lo | (hi << 32)

    # ---- key/mask/match registers (§6.2 fine-grained access) ----------
    def write_key(self, key: int) -> None:
        self.key_reg = self._to_bits(key, self.key_bits)
        self._match_fresh = False
        self._km_pushed.clear()
        self.command_log.append("W key_reg")

    def write_mask(self, mask: int) -> None:
        self.mask_reg = self._to_bits(mask, self.key_bits)
        self._match_fresh = False
        self._km_pushed.clear()
        self.command_log.append("W mask_reg")

    def read_match(self, alloc: Allocation, set_index: int = 0) -> int:
        """A read of the match pointer triggers (at most) one search."""
        if self._match_fresh:
            self.command_log.append("R match (fresh)")
            return self.match_reg
        set_id = alloc.base // self.set_cols + set_index
        if set_id not in self._km_pushed:
            self.command_log.append(f"W key/mask -> superset {set_id}")
            self._km_pushed.add(set_id)
        idx = int(xam_ops.xam_match_index(
            self.key_reg[None, :], self.cam_bits[set_id],
            self.mask_reg[None, :])[0])
        self.match_reg = -1 if idx < 0 else set_id * self.set_cols + idx
        self._match_fresh = True
        self.command_log.append(f"S set={set_id}")
        return self.match_reg

    # ---- convenience: Fig. 6 key-value store flow -----------------------
    def kv_lookup(self, keys_alloc: Allocation, data_alloc: Allocation,
                  key: int, mask: int = ~0) -> int | None:
        self.write_key(key)
        self.write_mask(mask & ((1 << self.key_bits) - 1))
        n_sets_used = (keys_alloc.n_elems + self.set_cols - 1) // self.set_cols
        for s in range(n_sets_used):
            m = self.read_match(keys_alloc, s)
            if m >= 0:
                return self.ram_read(data_alloc, m - keys_alloc.base)
            self._match_fresh = False  # advance to next set
        return None
