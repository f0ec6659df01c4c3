"""Mesh descriptions for the partition rules and the dry run (the
device-free part of ``repro/launch/mesh.py``).

A :class:`Mesh` is axis names and sizes, and holds no devices: it takes
the place of ``jax.sharding.Mesh`` wherever only its shape is read
(``dist/sharding.py``, ``launch/dryrun.py``).  Like the reference's these
are functions, never module-level constants, so importing this module
touches no device.

What waits for several processes (ROADMAP.md Queue 1 item 7):
``set_partitions``, ``make_set_mesh``, ``set_shard_devices``,
``set_axis_sharding``, ``replicated_sharding``, ``make_sharded_roll`` and
``make_grid_mesh``, which place the sharded index and the simulator's
grid over devices.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's axis names and the size of each axis."""

    axis_names: tuple
    shape: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} do not match "
                             f"the shape {self.shape}")

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: 16 x 16 ``("data", "model")``,
    or 2 x 16 x 16 ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(n_devices: int | None = None) -> Mesh:
    """``(n, 1)`` ``("data", "model")`` over this host's ``n`` visible CUDA
    cards.  Without a card it raises unless the caller names
    ``n_devices``."""
    if n_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass n_devices "
                               "to describe a host mesh without cards")
        n_devices = torch.cuda.device_count()
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    return Mesh(("data", "model"), (n_devices, 1))
