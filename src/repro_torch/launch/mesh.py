"""Meshes: port of ``repro/launch/mesh.py``.

A :class:`Mesh` is axis names and sizes, and for the one-axis meshes that
place state also the tuple of torch devices it spans.  It takes the place
of ``jax.sharding.Mesh``: the partition rules and the dry run read only
its shape (``dist/sharding.py``, ``launch/dryrun.py``); the serving
index's ``("sets",)`` mesh and the simulator's ``("grid",)`` mesh read its
devices.  Like the reference these keep its single-controller design: one
process drives a tuple of devices, one per partition.  Training over a
``("data", "model")`` mesh is the exception: there one process runs per
mesh position, and :func:`device_mesh` makes the ``torch.distributed``
``DeviceMesh`` that ``dist/sharding.place`` places the state over;
serving places its parameters and caches the same way
(``launch/serve.py``, ``launch/httpd.py``).  :func:`init_process` joins
a launcher to its ``torchrun`` group, and :func:`fake_world` stands a
process in for rank 0 of the production meshes' 256 or 512 ranks (the
dry run: no data moves).  A
device may repeat (``("cpu",) * 4``, ``("cuda:0",) * 4``), which plays
the role of the reference's forced host device count.  Like the
reference's these are functions, never module-level constants, so
importing this module touches no device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os

import torch

from repro_torch.core import geometry
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's axis names, the size of each axis and, where the
    mesh places state, the devices it spans (one per position of its one
    axis, repeats allowed; empty for a shape-only mesh)."""

    axis_names: tuple
    shape: tuple
    devices: tuple = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} do not match "
                             f"the shape {self.shape}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

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


def world_size() -> int:
    """The ``torch.distributed`` world size, 1 without an initialised
    process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_host_mesh(n_devices: int | None = None) -> Mesh:
    """``(n, 1)`` ``("data", "model")``: with an initialised process group
    over its ``world_size`` processes, one per mesh position (the
    reference's ``len(jax.devices())``); without one over this host's
    ``n`` visible CUDA cards, raising without a card unless the caller
    names ``n_devices``."""
    if n_devices is None and world_size() > 1:
        n_devices = world_size()
    if n_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass n_devices "
                               "to describe a host mesh without cards")
        n_devices = torch.cuda.device_count()
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    return Mesh(("data", "model"), (n_devices, 1))


def get_mesh(kind: str) -> Mesh:
    """A launcher's ``--mesh``: ``host`` is ``(world_size, 1)``;
    ``single`` and ``multi`` are the production meshes, which
    :func:`device_mesh` refuses unless their 256 or 512 processes run."""
    if kind == "host":
        return make_host_mesh(world_size())
    return make_production_mesh(multi_pod=(kind == "multi"))


def init_process(device: str) -> tuple[torch.device, str | None]:
    """(this process's device, the group's backend) by the launchers'
    device rule, joining the ``torchrun`` group when ``WORLD_SIZE`` > 1:
    ``cuda:LOCAL_RANK % device_count`` (raising without a card) unless
    ``device`` is the CPU; ``nccl`` where every process on the host has a
    card of its own, else ``gloo`` (ranks that share a card, which NCCL
    refuses, or the CPU).  (``device``, None) for one process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dist = torch.distributed
    if world == 1 and not dist.is_initialized():
        return resolve_device(device), None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        resolve_device("cuda")                   # raises without a card
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % n_cards)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= n_cards else "gloo"
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=world)
    return dev, backend


@contextlib.contextmanager
def fake_world(mesh: Mesh):
    """A ``torch.distributed`` group of backend ``"fake"`` in which this
    process is rank 0 of ``mesh.size`` ranks, destroyed on exit.  Its
    collectives move nothing and return at once, so a step placed over
    :func:`device_mesh` of ``mesh`` runs (on ``meta`` blocks) as rank 0
    would, issuing rank 0's collectives: the production meshes' dry run.
    Raises if a group is already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist = torch.distributed
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: Mesh, device_type: str):
    """``mesh`` as a ``torch.distributed`` ``DeviceMesh`` of
    ``device_type`` over the processes of the default group, one per mesh
    position in row-major order (a :func:`fake_world` too); None for a
    one-position mesh in a process without a group (the one-process
    path, plain tensors).
    Raises, as the reference's production mesh does, unless the world
    has exactly ``mesh.size`` processes."""
    have = world_size()
    if have != mesh.size:
        raise RuntimeError(f"need {mesh.size} devices for mesh "
                           f"{mesh.shape}, have {have} — launch "
                           f"{mesh.size} processes (torchrun "
                           f"--nproc-per-node)")
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, mesh.shape,
                            mesh_dim_names=mesh.axis_names)


def default_devices(device: str | torch.device = "cuda") -> tuple:
    """The devices an index or a simulator spreads over when the caller
    names none (the counterpart of ``jax.devices()``): every visible card
    for ``"cuda"``, the one named card for ``"cuda:k"``, else the one
    device (the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def _resolve_all(devices) -> tuple:
    return tuple(resolve_device(d) for d in devices)


def set_partitions(n_shards: int, devices) -> int:
    """Device-partition count for ``n_shards`` logical set shards over
    ``devices``: the largest divisor of ``n_shards`` that the device count
    holds, so partition boundaries coarsen shard boundaries; 1 with one
    device, where every shard co-locates.

    >>> set_partitions(4, ("cpu",) * 2), set_partitions(4, ("cpu",) * 3)
    (2, 2)
    >>> set_partitions(8, ("cpu",) * 8), set_partitions(4, ("cpu",))
    (8, 1)
    """
    n_dev = len(devices)
    if n_shards <= 1 or n_dev <= 1:
        return 1
    m = min(n_shards, n_dev)
    while n_shards % m != 0:
        m -= 1
    return m


def make_set_mesh(n_shards: int, devices) -> Mesh | None:
    """1-D ``("sets",)`` mesh over the first ``set_partitions(n_shards,
    devices)`` of ``devices``: partition k's planes, counters and wear
    state live on its k-th device.  None for one partition (every shard
    co-locates; the index takes the one-launch path)."""
    n = set_partitions(n_shards, devices)
    if n <= 1:
        return None
    return Mesh(("sets",), (n,), _resolve_all(devices[:n]))


def set_shard_devices(mesh: Mesh | None, n_shards: int) -> list | None:
    """Per-shard device over a ``make_set_mesh`` mesh, in contiguous
    blocks (shard k on ``devices[k * n_devices // n_shards]``, which
    agrees with the partitions' set blocks), or None without a mesh.

    >>> m = make_set_mesh(4, ("cpu", "meta"))
    >>> [d.type for d in set_shard_devices(m, 4)]
    ['cpu', 'cpu', 'meta', 'meta']
    """
    if mesh is None:
        return None
    devs = mesh.devices
    return [devs[k * len(devs) // n_shards] for k in range(n_shards)]


def set_axis_sharding(mesh: Mesh, x: torch.Tensor) -> list:
    """A global ``(n_sets, ...)`` tensor split along its leading axis into
    one contiguous block per mesh position, block k placed (copied) on
    device k: the layout of every per-partition plane list."""
    n = mesh.size
    if x.shape[0] % n != 0:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} "
                         "partitions")
    s_loc = x.shape[0] // n
    return [x[k * s_loc:(k + 1) * s_loc].to(dev, copy=True)
            for k, dev in enumerate(mesh.devices)]


def replicated_sharding(mesh: Mesh, x):
    """``x`` (a tensor, or a dataclass of tensors such as
    ``wear.WearDyn``) placed once on each distinct device of the mesh:
    ``{device: copy}``.  The small operands every partition reads whole
    (the wear knobs, the no-allocate threshold) are placed at
    construction, so a batch's dispatch moves none of them."""
    out = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = _to(x, dev)
    return out


def _to(x, dev: torch.device):
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev)
                          for f in dataclasses.fields(x)})
    return x.to(dev) if isinstance(x, torch.Tensor) else x


@functools.lru_cache(maxsize=None)
def make_sharded_roll(mesh: Mesh, n_rows: int, shift: int):
    """The cyclic roll ``new[g] = old[(g - shift) mod n_rows]`` along the
    leading (set) axis of per-partition tensor lists, as a boundary
    exchange (``geometry.shard_roll_plan``): with ``shift = q * s_loc +
    r``, partition k's new block is ``cat(old[k-q-1][s_loc-r:],
    old[k-q][:s_loc-r])`` (indices mod the mesh size), placed on device
    k.  Only the ``r`` boundary sets of each block cross to a neighbour
    beside the block-aligned slab, and no plane data goes through numpy.

    Returns ``roll(*part_lists) -> tuple`` of new lists (one per input,
    same shapes and devices).  Every new block is built before the caller
    rebinds any, so each reads the old blocks."""
    m = mesh.size
    s_loc = geometry.sets_per_shard(n_rows, m)
    q, r, _low, _high = geometry.shard_roll_plan(shift, n_rows, m)

    def roll_one(parts: list) -> list:
        if len(parts) != m:
            raise ValueError(f"{len(parts)} partitions on a mesh of {m}")
        out = []
        for k, dev in enumerate(mesh.devices):
            low = parts[(k - q) % m][:s_loc - r].to(dev)
            if r:
                high = parts[(k - q - 1) % m][s_loc - r:].to(dev)
                out.append(torch.cat([high, low], dim=0))
            else:
                out.append(low)
        return out

    def roll(*part_lists):
        return tuple(roll_one(parts) for parts in part_lists)

    return roll


def make_grid_mesh(grid_size: int, devices) -> Mesh | None:
    """1-D ``("grid",)`` mesh over ``devices`` for the batched simulator's
    config x trace lanes, or None where spreading cannot help (one
    device) or cannot be even (the grid does not divide the device count)
    — the caller then runs one unsharded family, as the reference does."""
    n = len(devices)
    if n <= 1 or grid_size % n != 0:
        return None
    return Mesh(("grid",), (n,), _resolve_all(devices))
