"""Monarch address geometry (paper §6, Figures 4 and 7) — port of
``repro/core/geometry.py`` over torch tensors.

Hierarchy (Table 3, 8 GB Monarch):

    8 vaults x 64 banks/vault x 512 supersets/bank x 8 sets/superset
      x 64 rows/set, one row = one 64 B block (512 bits across 8 subarrays).

Supersets are 8x8 grids of 64x64 XAM subarrays; the subarray at (i, j)
belongs to set k = (j - i) % 8 (diagonal arrangement, Fig. 4).  The §8
rotary offsets rotate vault/bank/superset/set IDs by distinct primes on
every rotate signal.  ``shard_of_set`` and ``shard_roll_plan`` carry
the serving index's contiguous-block set shards.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

BLOCK_BYTES = 64
SET_WAYS = 512  # columns searchable per set == cache associativity


@dataclasses.dataclass(frozen=True)
class MonarchGeometry:
    """Table 3's stated 8 GB stack.  Its listed fields multiply to 4 GB;
    the reference keeps the stated capacity by using 512 supersets/bank,
    and so does the port."""
    n_vaults: int = 8
    banks_per_vault: int = 64
    supersets_per_bank: int = 512
    sets_per_superset: int = 8
    rows_per_set: int = 64
    subarray_rows: int = 64
    subarray_cols: int = 64
    superset_grid: int = 8  # 8x8 subarrays

    @property
    def blocks_per_set(self) -> int:
        return self.rows_per_set

    @property
    def blocks_per_superset(self) -> int:
        return self.sets_per_superset * self.rows_per_set  # 512

    @property
    def total_supersets(self) -> int:
        return self.n_vaults * self.banks_per_vault * self.supersets_per_bank

    @property
    def total_blocks(self) -> int:
        return self.total_supersets * self.blocks_per_superset

    @property
    def capacity_bytes(self) -> int:
        return self.total_blocks * BLOCK_BYTES

    def scaled(self, factor: int) -> "MonarchGeometry":
        """Uniformly scale down the superset count for simulation (ratios
        preserved; per-set geometry untouched)."""
        if factor < 1:
            raise ValueError(f"scale factor {factor} must be >= 1")
        ss = max(self.supersets_per_bank // factor, 1)
        return dataclasses.replace(self, supersets_per_bank=ss)


GEOM_8GB = MonarchGeometry()


# Diagonal set selection (Fig. 4).

def set_of_subarray(i, j, grid: int = 8):
    """Set id of the subarray at superset grid position (row i, col j)."""
    return (j - i) % grid


def subarrays_of_set(k: int, grid: int = 8):
    """The 8 (i, j) positions selected for set k — one per grid row."""
    return [(i, (i + k) % grid) for i in range(grid)]


def port_select(k: int, mode_column_in: bool, grid: int = 8):
    """Which port (row/column) each selected subarray drives, per the port
    selector's mode latch: ``[(i, j, port)]``, port in {"col", "row"}."""
    port = "col" if mode_column_in else "row"
    return [(i, j, port) for (i, j) in subarrays_of_set(k, grid)]


def sets_per_shard(n_sets: int, n_shards: int) -> int:
    """Sets owned by each shard under contiguous-block ownership.

    >>> sets_per_shard(8, 4)
    2
    """
    if n_shards < 1 or n_sets % n_shards != 0:
        raise ValueError(
            f"n_shards={n_shards} must be >=1 and divide n_sets={n_sets}")
    return n_sets // n_shards


def shard_of_set(set_ids, n_sets: int, n_shards: int):
    """Global physical set ids -> ``(shard, local_set)``: shard ``k`` owns
    the contiguous block ``[k * sets_per_shard, (k + 1) *
    sets_per_shard)``, a pure relabeling, so no hit, install or wear
    decision depends on the shard count.

    >>> shard, local = shard_of_set(torch.arange(4), 4, 2)
    >>> shard.tolist(), local.tolist()
    ([0, 0, 1, 1], [0, 1, 0, 1])
    """
    s_local = sets_per_shard(n_sets, n_shards)
    return set_ids // s_local, set_ids % s_local


def shard_set_slice(shard: int, n_sets: int, n_shards: int) -> slice:
    """Global-set slice owned by ``shard`` (contiguous-block ownership)."""
    s_local = sets_per_shard(n_sets, n_shards)
    return slice(shard * s_local, (shard + 1) * s_local)


def shard_roll_plan(shift: int, n_sets: int, n_parts: int):
    """The global cyclic set roll ``new[g] = old[(g - shift) mod n_sets]``
    factored into per-shard moves.  With ``s_loc = n_sets // n_parts``
    and ``shift = q * s_loc + r`` (``0 <= r < s_loc``), each source shard
    ``j`` sends its low ``s_loc - r`` rows to shard ``j + q`` and its high
    ``r`` rows to shard ``j + q + 1``.  Returns ``(q, r, low_perm,
    high_perm)``: the ``(source, destination)`` pairs of the low and high
    slabs, or None where that slab stays on its shard (identity
    permutation, or no boundary slab when ``r == 0``).

    >>> shard_roll_plan(7, 8, 4)
    (3, 1, [(0, 3), (1, 0), (2, 1), (3, 2)], None)
    >>> shard_roll_plan(1, 8, 4)
    (0, 1, None, [(0, 1), (1, 2), (2, 3), (3, 0)])
    >>> shard_roll_plan(2, 8, 4)
    (1, 0, [(0, 1), (1, 2), (2, 3), (3, 0)], None)
    """
    s_loc = sets_per_shard(n_sets, n_parts)
    if not 0 < shift < n_sets:
        raise ValueError(f"shift={shift} must be in (0, {n_sets})")
    q, r = divmod(shift, s_loc)
    low_perm = ([(j, (j + q) % n_parts) for j in range(n_parts)]
                if q % n_parts != 0 else None)
    high_perm = ([(j, (j + q + 1) % n_parts) for j in range(n_parts)]
                 if r != 0 and (q + 1) % n_parts != 0 else None)
    return q, r, low_perm, high_perm


# Rotary offsets (§8): primes per level, vault bumped every 8th rotate.
ROTATE_PRIMES = {"bank": 1, "set": 3, "vault": 5, "superset": 7}


@dataclasses.dataclass(frozen=True)
class RotaryOffsets:
    vault: torch.Tensor  # scalar int32
    bank: torch.Tensor
    superset: torch.Tensor
    set_: torch.Tensor
    rotate_count: torch.Tensor


def zero_offsets(device: str | torch.device = "cuda",
                 lanes: int | None = None) -> RotaryOffsets:
    """Fresh offsets: int32 scalars, or ``(lanes,)`` vectors for a state
    with a leading lane axis (the batched simulator's)."""
    device = resolve_device(device)
    shape = () if lanes is None else (lanes,)
    z = lambda: torch.zeros(shape, dtype=torch.int32, device=device)
    return RotaryOffsets(z(), z(), z(), z(), z())


def apply_rotate(off: RotaryOffsets) -> RotaryOffsets:
    """Bump offsets by the unique primes; vault only every 8 rotates."""
    rc = off.rotate_count + 1
    vault = off.vault + torch.where(
        rc % 8 == 0, ROTATE_PRIMES["vault"], 0).to(torch.int32)
    return RotaryOffsets(
        vault=vault.to(torch.int32),
        bank=(off.bank + ROTATE_PRIMES["bank"]).to(torch.int32),
        superset=(off.superset + ROTATE_PRIMES["superset"]).to(torch.int32),
        set_=(off.set_ + ROTATE_PRIMES["set"]).to(torch.int32),
        rotate_count=rc.to(torch.int32),
    )


# Address decomposition: linear block address -> physical coordinates.
# Bit layout (low to high): set-row | set | superset | bank | vault.

@dataclasses.dataclass(frozen=True)
class BlockCoord:
    vault: torch.Tensor
    bank: torch.Tensor
    superset: torch.Tensor
    set_: torch.Tensor
    row: torch.Tensor

    def flat_superset(self, g: MonarchGeometry) -> torch.Tensor:
        return (self.vault * g.banks_per_vault
                + self.bank) * g.supersets_per_bank + self.superset


def decompose(block_addr, g: MonarchGeometry,
              off: RotaryOffsets | None = None) -> BlockCoord:
    """int32 coordinates of ``block_addr`` (floor ``%``/``//`` on int32,
    as the reference), rotated by ``off`` when given."""
    a = torch.as_tensor(block_addr).to(torch.int32)
    row = a % g.rows_per_set
    a = a // g.rows_per_set
    set_ = a % g.sets_per_superset
    a = a // g.sets_per_superset
    superset = a % g.supersets_per_bank
    a = a // g.supersets_per_bank
    bank = a % g.banks_per_vault
    a = a // g.banks_per_vault
    vault = a % g.n_vaults
    if off is not None:
        vault = (vault + off.vault) % g.n_vaults
        bank = (bank + off.bank) % g.banks_per_vault
        superset = (superset + off.superset) % g.supersets_per_bank
        set_ = (set_ + off.set_) % g.sets_per_superset
    to32 = lambda x: x.to(torch.int32)
    return BlockCoord(to32(vault), to32(bank), to32(superset), to32(set_),
                      to32(row))


def compose(c: BlockCoord, g: MonarchGeometry) -> torch.Tensor:
    """Inverse of :func:`decompose` without offsets (int32)."""
    a = c.vault.to(torch.int32)
    a = a * g.banks_per_vault + c.bank
    a = a * g.supersets_per_bank + c.superset
    a = a * g.sets_per_superset + c.set_
    a = a * g.rows_per_set + c.row
    return a


# Fig. 7: coordinated RAM <-> CAM mapping for cache mode.  Every RAM
# superset (512 blocks) corresponds to one CAM set (512 tag columns); the
# RAM bank ID supplies the CAM set / bank / key bits.

@dataclasses.dataclass(frozen=True)
class CamCoord:
    bank: torch.Tensor     # CAM bank within the vault's CAM partition
    set_: torch.Tensor     # set within the CAM superset
    key_id: torch.Tensor   # which tag of the column (0: low half, 1: high)


def ram_to_cam(ram_bank, g: MonarchGeometry,
               n_cam_banks: int = 2) -> CamCoord:
    """Map a RAM bank id to the (cam_bank, set, key_id) holding its tags:
    low bits pick the set, the next bit the CAM bank, the top the key."""
    b = torch.as_tensor(ram_bank).to(torch.int32)
    set_ = b % g.sets_per_superset
    rest = b // g.sets_per_superset
    cam_bank = rest % n_cam_banks
    key_id = rest // n_cam_banks
    return CamCoord(cam_bank.to(torch.int32), set_.to(torch.int32),
                    key_id.to(torch.int32))
