"""Set-axis shard arithmetic and the §8 rotary offsets (port of the parts
of ``repro/core/geometry.py`` the serving path uses)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


def sets_per_shard(n_sets: int, n_shards: int) -> int:
    """Sets owned by each shard under contiguous-block ownership.

    >>> sets_per_shard(8, 4)
    2
    """
    if n_shards < 1 or n_sets % n_shards != 0:
        raise ValueError(
            f"n_shards={n_shards} must be >=1 and divide n_sets={n_sets}")
    return n_sets // n_shards


def shard_set_slice(shard: int, n_sets: int, n_shards: int) -> slice:
    """Global-set slice owned by ``shard`` (contiguous-block ownership)."""
    s_local = sets_per_shard(n_sets, n_shards)
    return slice(shard * s_local, (shard + 1) * s_local)


# Rotary offsets (§8): primes per level, vault bumped every 8th rotate.
ROTATE_PRIMES = {"bank": 1, "set": 3, "vault": 5, "superset": 7}


@dataclasses.dataclass(frozen=True)
class RotaryOffsets:
    vault: torch.Tensor  # scalar int32
    bank: torch.Tensor
    superset: torch.Tensor
    set_: torch.Tensor
    rotate_count: torch.Tensor


def zero_offsets(device: str | torch.device = "cuda") -> RotaryOffsets:
    device = resolve_device(device)
    z = lambda: torch.zeros((), dtype=torch.int32, device=device)
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
