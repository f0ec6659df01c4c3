"""MonarchKVIndex — port of ``repro/serve/kv_index.py``.

A paged KV prefix cache whose INDEX is a Monarch flat-CAM: every 16-token
chunk is fingerprinted (murmur3), each fingerprint maps to one of
``n_sets`` CAM sets under a rotary offset, and the set's ``set_ways``
columns hold stored fingerprint bits, a validity plane, the fingerprint
itself, D̄&R̄ re-read counters and the §8 wear state.

* LOOKUP: the whole batch is answered by ONE fused multi-set search
  (``kernels/xam_search``: the Hopper kernel on the card, its plain
  version on the CPU).
* ADMISSION: ``admit_fps`` packs candidates into the round grid of
  ``group_admits_stacked`` — round r holds each set's rank-r candidate,
  so the sets of one round are pairwise distinct — and
  :func:`_admit_round` admits round after round, each round vectorized
  over its lanes: residency probe, no-allocate gate, t_MWW throttle
  (``core/wear.py``), cold-victim way selection, column install and wear
  recording.  Bit-equal to admitting one fingerprint at a time in batch
  order.  The decisions come back to the host in one transfer per
  partition, the only synchronisation of an admission.
* ROTATION: every ``rotate_every`` admissions the planes roll by the
  prime stride 7 in lockstep with the ``_set_of`` offset, so resident
  entries stay searchable.

All index state lives on the partitions' devices and changes in place
(or is rebound, by a rotation across partitions), where the reference
donated its buffers.  The fingerprint plane is stored as int32
(the bit pattern of the uint32 fingerprint — torch's uint32 support is
partial); equality is all the index asks of it, and every report views it
back as uint32.  Lookups (serving thread) and admissions (``AdmitQueue``
worker) both run on each card's default stream, so the card orders them.

SHARDS: ``n_shards`` splits the sets into contiguous blocks
(``geometry.shard_of_set``).  Under ``dispatch="auto"`` the state lives
in ``n_parts = mesh.set_partitions(n_shards, devices)`` partitions, one
per device of the ``("sets",)`` mesh (``launch/mesh.py``), as in the
reference's single controller: one process drives a tuple of devices.
``devices`` defaults to every visible card (``"cuda"``) or the one CPU,
so on one card every shard co-locates (``n_parts == 1``) and the path
above runs bit for bit.  With several partitions a lookup is one
grouping of the batch and one search launch per partition on its device
(``xam_search_multiset_stacked``), an admission runs each partition's
rounds of the round grid on its device, round r on every partition
before round r + 1, and a rotation is a boundary exchange
(``mesh.make_sharded_roll``) that moves no plane data through the host.
A device may repeat (``("cpu",) * 4``, ``("cuda:0",) * 4``).
``dispatch="fanout"`` keeps the reference's differential oracles: state
in one partition per logical shard (placed by ``mesh.set_shard_devices``),
one search launch per shard that holds queries, admission by the
per-candidate :func:`_admit_batch` scan of each partition, rotation
through the global views.  Every hit, install, eviction, throttle and
wear report is the same at every shard count, partition count and
placement under either dispatch.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import geometry
from repro_torch.core import lifetime as lifetime_mod
from repro_torch.core import wear
from repro_torch.core.timing import SECONDS_PER_YEAR, t_mww_seconds
from repro_torch.data.pipeline import (fingerprint_blocks, murmur3_np,
                                       prefix_fingerprint_blocks)
from repro_torch.device import resolve_device
from repro_torch.kernels.common import pack_bits_np, resolve_plane_format
from repro_torch.kernels.xam_search import ops as xam_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.pytree import tree_leaves

CHUNK_TOKENS = 16
ROTATE_STRIDE = 7          # prime set stride per rotation (§8)
ADMIT_BUCKET_LO = 8        # pow2 bucket floor for admit batch shapes

@dataclasses.dataclass
class KVIndexConfig:
    """Serving-index geometry and §8 durability knobs (fields as in the
    reference: ``n_sets`` CAM sets of ``set_ways`` columns, ``key_bits``
    fingerprint bits per column, the no-allocate threshold
    ``admit_after_reads``, the per-way write budget ``m_writes`` per
    t_MWW window of ``window_ops`` cycles in the ``clock`` domain
    ("ops" or "wall" microseconds), ``rotate_every`` admissions between
    rotary remaps, ``n_shards`` set shards (dividing ``n_sets``),
    ``plane_format`` ("int8" or "packed8"; None reads
    ``REPRO_PLANE_FORMAT``) and the chunk ``fingerprint`` scheme ("block"
    or "prefix")."""
    n_sets: int = 32
    set_ways: int = 512           # CAM columns per set
    key_bits: int = 32
    admit_after_reads: int = 1    # no-allocate: admit on 2nd touch
    m_writes: int = 3             # per-way write budget per t_MWW window
    window_ops: int = 4096        # t_MWW window length in clock cycles
    rotate_every: int = 50_000    # admissions between rotary remaps
    n_shards: int = 1             # set-axis shards (divides n_sets)
    plane_format: str | None = None  # None = REPRO_PLANE_FORMAT env knob
    clock: str = "ops"            # t_MWW cycle domain: "ops" | "wall"
    fingerprint: str = "block"    # chunk hashing: "block" | "prefix"

    @classmethod
    def with_lifetime(cls, *, t_life_years: float, endurance: float = 1e8,
                      ops_per_second: float = 1e6, m_writes: int = 3,
                      clock: str = "ops", **kw) -> "KVIndexConfig":
        """Derive ``window_ops`` from a lifetime target (§6.2):
        ``t_MWW = M * T_life / endurance`` seconds, converted to ops at
        ``ops_per_second`` under ``clock="ops"`` or to wall microseconds
        under ``clock="wall"``.

        >>> KVIndexConfig.with_lifetime(t_life_years=10.0).window_ops
        9467280
        >>> KVIndexConfig.with_lifetime(
        ...     t_life_years=10.0, clock="wall").window_ops
        9467280
        """
        t_mww_s = t_mww_seconds(m_writes, t_life_years * SECONDS_PER_YEAR,
                                endurance)
        hz = ops_per_second if clock == "ops" else wear.WALL_HZ
        window_ops = max(int(t_mww_s * hz), 1)
        return cls(m_writes=m_writes, window_ops=window_ops, clock=clock,
                   **kw)


@dataclasses.dataclass
class KVIndexStats:
    lookups: int = 0
    chunk_hits: int = 0
    chunk_misses: int = 0
    admissions: int = 0
    admission_skips: int = 0      # no-allocate first touches
    throttled: int = 0            # t_MWW window exhausted
    evictions: int = 0
    rotations: int = 0
    searches: int = 0             # lookup launches (1 per batch; 1 per
                                  # shard holding queries on "fanout")
    admit_calls: int = 0          # admission dispatches (1 per batch; 1
                                  # per partition holding candidates on
                                  # "fanout")


class KVSlabStore:
    """KV slab store kept in LOCKSTEP with the index.

    Slabs are keyed by the uint32 fingerprints the index stores: a slab
    is **staged** when its chunk's KV is computed, **committed** when the
    fingerprint installs (or refreshes a resident entry), **discarded**
    when the offer is skipped or throttled, and **dropped** when its way
    is evicted.  Rotation never touches the store (keys are fingerprints,
    not slots).  Thread-safe: staging (serving thread) may race commits
    (admission worker).  A slab is a dict tree of tensors, counted only
    for its bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._staged: dict[int, object] = {}
        self._resident: dict[int, object] = {}

    @staticmethod
    def _nbytes(slab) -> int:
        return sum(int(leaf.numel() * leaf.element_size())
                   for leaf in tree_leaves(slab))

    def stage(self, fp: int, slab) -> None:
        """Hold a freshly computed slab until its admission decides."""
        with self._lock:
            self._staged[int(fp)] = slab

    def commit(self, fp: int) -> None:
        """Fingerprint installed (or re-offered while resident): promote
        its staged slab; no-op when nothing is staged."""
        with self._lock:
            slab = self._staged.pop(int(fp), None)
            if slab is not None:
                self._resident[int(fp)] = slab

    def discard(self, fp: int) -> None:
        """Offer skipped/throttled/shed: the staged slab is garbage."""
        with self._lock:
            self._staged.pop(int(fp), None)

    def drop(self, fp: int) -> None:
        """Fingerprint evicted from its way: its resident slab dies."""
        with self._lock:
            self._resident.pop(int(fp), None)

    def get(self, fp: int):
        """Resident slab for ``fp``, or None (staged slabs are not
        servable)."""
        with self._lock:
            return self._resident.get(int(fp))

    def resident_fps(self) -> set[int]:
        with self._lock:
            return set(self._resident)

    def staged_fps(self) -> set[int]:
        with self._lock:
            return set(self._staged)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._nbytes(s) for s in self._resident.values())


def _install_column(bits, valid, fp_of, s, w, bitcol, fp):
    """Install ONE CAM column on a partition's planes, in place (the
    reference's ``_install_column``, the one-column install the batched
    admission replaced, kept for the host-loop admission flow its
    benchmark measures): ``bits[s, :, w] = bitcol`` (a ``(key_bits,)``
    int8 bit row, or ``(key_bits // 8,)`` uint8 packed words),
    ``valid[s, w] = 1`` and ``fp_of[s, w] = fp`` (the uint32
    fingerprint's bit pattern, as the int32 plane stores it).  ``s`` and
    ``w`` are ints or 0-d integer tensors.  Returns the three planes."""
    bits[s, :, w] = torch.as_tensor(bitcol).to(bits.device, bits.dtype)
    valid[s, w] = 1
    fp_of[s, w] = int(np.asarray(fp, np.uint32).view(np.int32))
    return bits, valid, fp_of


def _admit_round(st: dict, ws: wear.WearState, wdyn: wear.WearDyn,
                 admit_after, lanes: slice, sets, fps, bitcols, cycles,
                 touches, outs: dict) -> wear.WearState:
    """One round of the segmented-parallel admission of one partition.

    ``sets`` (partition-local)/``fps`` (int32 view)/``bitcols``/
    ``cycles``/``touches`` are the partition's candidates on its device,
    ordered by round; ``lanes`` slices this round's, whose sets are
    pairwise distinct.  Every lane is a real candidate (the host drops
    the grid's padding before upload), so each write below targets a
    distinct (set, way) and nothing collides.  Updates the planes in
    ``st`` in place (the reference donated them), writes the lanes'
    decisions into ``outs`` and returns the new wear state.  Device work
    only: nothing is read back to the host."""
    bits, valid, fp_of, read_after = (st["bits"], st["valid"], st["fp_of"],
                                      st["read_after"])
    n_ways = valid.shape[1]
    iota = torch.arange(n_ways, dtype=torch.int32, device=valid.device)
    s = sets[lanes].long()                      # (K,) distinct sets
    fp, bitcol = fps[lanes], bitcols[lanes]
    cycle, touch = cycles[lanes], touches[lanes]

    vrow = valid[s]                             # (K, W)
    frow = fp_of[s]
    hitv = (vrow == 1) & (frow == fp[:, None])
    is_res = hitv.any(dim=1)
    res_w = hitv.to(torch.int32).argmax(dim=1)  # first max, 0 if none
    # resident re-offer: D/R metadata only (marks the way re-read).
    read_after[s, res_w] += is_res.to(torch.int32)

    # no-allocate gate (D̄&R̄ "never accessed" filter).
    skipped = ~is_res & (touch < admit_after)

    # t_MWW lifetime throttle (reject-before-write, per-set window).
    locked = wear.is_locked(ws, s, cycle)
    over = wear.window_would_exceed(ws, wdyn, s, cycle)
    throttled = ~is_res & ~skipped & (locked | over)
    install = ~is_res & ~skipped & ~throttled

    # Way selection: first free way, else counter-ordered cold victim.
    free = vrow == 0
    has_free = free.any(dim=1)
    free_w = free.to(torch.int32).argmax(dim=1)
    order = (iota[None, :] + st["counter"][s][:, None]) % n_ways
    cold = torch.gather(read_after[s], 1, order.long()) == 0
    first_cold = torch.gather(
        order, 1, cold.to(torch.int32).argmax(dim=1, keepdim=True))[:, 0]
    victim = torch.where(cold.any(dim=1), first_cold, order[:, 0])
    way = torch.where(has_free, free_w, victim).to(torch.int32)
    wl = way.long()
    evict = install & ~has_free
    old_fp = torch.gather(frow, 1, wl[:, None])[:, 0]
    st["counter"][s] += evict.to(torch.int32)

    # Column install: installing lanes write their column, the others
    # write back what is there ((set, way) pairs are distinct).
    keep = lambda new, cur: torch.where(
        install.view(-1, *([1] * (cur.dim() - 1))), new, cur)
    bits[s, :, wl] = keep(bitcol.to(bits.dtype), bits[s, :, wl])
    valid[s, wl] = keep(torch.ones_like(vrow[:, 0]), valid[s, wl])
    fp_of[s, wl] = keep(fp, fp_of[s, wl])
    read_after[s, wl] = keep(torch.zeros_like(way), read_after[s, wl])
    st["set_writes"][s] += install.to(torch.int32)

    # Wear recording fused with the install (§8 record_write
    # semantics over the round's distinct rows).
    ws = wear.record_write_rows(ws, wdyn, s, cycle, install)

    for k, v in (("is_res", is_res), ("skipped", skipped),
                 ("throttled", throttled), ("install", install),
                 ("way", way), ("evict", evict), ("old_fp", old_fp)):
        outs[k][lanes] = v
    return ws


def _where_tree(cond: torch.Tensor, new, old):
    """``torch.where(cond, new, old)`` over every tensor of a (nested)
    dataclass such as a ``WearState``."""
    if dataclasses.is_dataclass(old):
        return type(old)(**{
            f.name: _where_tree(cond, getattr(new, f.name),
                                getattr(old, f.name))
            for f in dataclasses.fields(old)})
    return torch.where(cond, new, old)


def _admit_batch(st: dict, ws: wear.WearState, wdyn: wear.WearDyn,
                 admit_after: int, sets, fps, bitcols, cycles, touches):
    """The per-candidate admission scan of one partition (the reference's
    ``_admit_batch``, the ``admit_dispatch="fanout"`` oracle): candidates
    one after another in batch order, each through the whole pipeline —
    residency probe, no-allocate gate, t_MWW throttle, cold-victim way
    selection, column install and §8 ``wear.record_write`` — so later
    candidates see earlier installs and evictions.  A Python loop over
    the candidates on device tensors; no step reads back to the host.
    The reference pads the batch to a pow2 with inactive lanes, which
    change neither the state nor a kept output, so only the real
    candidates run.  Updates ``st`` in place; returns ``(wear_state,
    outs)`` with the decision tensors in candidate order."""
    bits, valid, fp_of, read_after = (st["bits"], st["valid"], st["fp_of"],
                                      st["read_after"])
    counter, set_writes = st["counter"], st["set_writes"]
    n_ways = valid.shape[1]
    dev = valid.device
    iota = torch.arange(n_ways, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.bool, device=dev)
    names = ("is_res", "skipped", "throttled", "install", "way", "evict",
             "old_fp")
    rows = []
    for i in range(sets.shape[0]):
        s = sets[i].long()
        fp, bitcol, cycle, touch = fps[i], bitcols[i], cycles[i], touches[i]

        vrow = valid[s].clone()
        frow = fp_of[s].clone()
        hitv = (vrow == 1) & (frow == fp)
        is_res = hitv.any()
        res_w = hitv.to(torch.int32).argmax()
        read_after[s, res_w] += is_res.to(torch.int32)

        skipped = ~is_res & (touch < admit_after)
        locked = wear.is_locked(ws, s, cycle)
        over = wear.window_would_exceed(ws, wdyn, s, cycle)
        throttled = ~is_res & ~skipped & (locked | over)
        install = ~is_res & ~skipped & ~throttled

        free = vrow == 0
        has_free = free.any()
        free_w = free.to(torch.int32).argmax()
        order = (iota + counter[s]) % n_ways
        cold = read_after[s][order.long()] == 0
        victim = torch.where(cold.any(),
                             order[cold.to(torch.int32).argmax()], order[0])
        way = torch.where(has_free, free_w, victim).to(torch.int32)
        wl = way.long()
        evict = install & ~has_free
        old_fp = frow[wl]
        counter[s] += evict.to(torch.int32)

        bits[s, :, wl] = torch.where(install, bitcol.to(bits.dtype),
                                     bits[s, :, wl])
        valid[s, wl] = torch.where(install, 1, vrow[wl]).to(torch.int8)
        fp_of[s, wl] = torch.where(install, fp, old_fp)
        read_after[s, wl] = torch.where(install, 0, read_after[s, wl]).to(
            torch.int32)
        set_writes[s] += install.to(torch.int32)

        ws2, _rot, _fl = wear.record_write(ws, wdyn, s, one, cycle)
        ws = _where_tree(install, ws2, ws)
        rows.append((is_res, skipped, throttled, install, way, evict,
                     old_fp))
    outs = {k: torch.stack([r[j] for r in rows]) if rows else
            torch.empty(0, device=dev) for j, k in enumerate(names)}
    return ws, outs


def _shard_property(name: str, doc: str, settable: bool = True):
    """Global view over a per-partition list of tensors: THE tensor of
    partition 0 when there is one partition, else the partitions
    concatenated in set order on partition 0's device.  Assigning a
    global tensor re-splits it into one contiguous block per partition,
    each placed on its partition's device."""
    def get(self):
        parts = getattr(self, name)
        if len(parts) == 1:
            return parts[0]
        return torch.cat([x.to(self.device) for x in parts], dim=0)

    def set_(self, value):
        parts = getattr(self, name)
        if len(parts) == 1:
            parts[0] = value
        else:
            setattr(self, name,
                    mesh_mod.set_axis_sharding(self._placement, value))

    return property(get, set_ if settable else None, None, doc)


class MonarchKVIndex:
    """Set-partitioned Monarch flat-CAM prefix index (see module
    docstring).

    Parameters
    ----------
    cfg : KVIndexConfig, optional
        Geometry/durability knobs; default-constructed per instance.
    dispatch : {"auto", "fanout"}
        ``"auto"``: one partition per device of the ``("sets",)`` mesh
        (one when every shard co-locates), one grouping and one search
        launch per partition per lookup, the round-grid admission, the
        boundary-exchange rotation.  ``"fanout"``: the reference's
        differential oracle — one partition per logical shard, one search
        launch per shard holding queries, rotation through the global
        views.  No result depends on it.
    admit_dispatch : {"auto", "fanout"} or None
        Admission policy; None follows ``dispatch``.  ``"fanout"`` runs
        the per-candidate :func:`_admit_batch` scan of each partition
        holding candidates.  Fanout storage admits only through fanout.
    now_fn : callable, optional
        Wall-clock source for ``clock="wall"`` configs (monotonic seconds;
        default ``time.monotonic``).  Never consulted under ``clock="ops"``.
    slab_store : KVSlabStore, optional
        Kept in lockstep by the admission fold.
    device : str or torch.device
        Where the index lives when ``devices`` is None: ``"cuda"`` (the
        default; raises when no card is visible) spreads it over every
        visible card, ``"cuda:k"`` or ``"cpu"`` keeps it on that one
        device.
    devices : sequence of devices, optional
        The partitions' devices, one per mesh position; repeats allowed
        (``("cpu",) * 4`` partitions the index four ways on the CPU).
        The index takes the first ``set_partitions(n_shards, devices)``.

    Attributes
    ----------
    bits, valid, fp_of, read_after, set_writes, counter : torch.Tensor
        Global views of the CAM state on ``device``: ``(n_sets,
        key_bits, set_ways)`` int8 stored bits (``(n_sets, key_bits // 8,
        set_ways)`` uint8 packed words under ``plane_format="packed8"``),
        ``(n_sets, set_ways)`` validity (int8), fingerprint (int32
        holding the uint32 bit pattern) and D̄&R̄ (int32) planes, and the
        ``(n_sets,)`` int32 install and replacement counters.  With one
        partition these are THE state tensors; with several, a
        concatenation of the partitions' on partition 0's device
        (assigning the first four re-splits them onto the partitions'
        devices).
    n_shards, sets_per_shard : int
        Logical set shards and the sets each owns.
    n_parts, sets_per_part : int
        Partitions holding state: the ``("sets",)`` mesh size under
        ``"auto"`` (1 with one device: every shard co-locates),
        ``n_shards`` under ``"fanout"``.
    set_mesh : launch.mesh.Mesh or None
        The ``("sets",)`` mesh, None when the devices hold one partition.
    device : torch.device
        Partition 0's device, where the global views gather.

    Examples
    --------
    >>> import numpy as np
    >>> idx = MonarchKVIndex(KVIndexConfig(
    ...     n_sets=4, set_ways=16, admit_after_reads=0), device="cpu")
    >>> toks = np.arange(1, 65, dtype=np.int32).reshape(1, 64)
    >>> idx.admit(toks)                       # install 4 chunks
    >>> bool(idx.lookup(toks).all())          # now resident
    True
    """

    def __init__(self, cfg: KVIndexConfig | None = None,
                 dispatch: str = "auto", admit_dispatch: str | None = None,
                 now_fn=None, slab_store: KVSlabStore | None = None,
                 device: str | torch.device = "cuda", devices=None):
        assert dispatch in ("auto", "fanout"), dispatch
        if admit_dispatch is None:
            admit_dispatch = dispatch
        assert admit_dispatch in ("auto", "fanout"), admit_dispatch
        assert not (dispatch == "fanout" and admit_dispatch == "auto"), (
            "dispatch='fanout' storage only supports fanout admission")
        self.cfg = KVIndexConfig() if cfg is None else cfg
        c = self.cfg
        if c.clock not in wear.CLOCKS:
            raise ValueError(
                f"KVIndexConfig.clock={c.clock!r}: expected one of "
                f"{wear.CLOCKS}")
        if c.fingerprint not in ("block", "prefix"):
            raise ValueError(
                f"KVIndexConfig.fingerprint={c.fingerprint!r}: expected "
                "'block' or 'prefix'")
        self.slab_store = slab_store
        self.clock = c.clock
        self._now_fn = time.monotonic if now_fn is None else now_fn
        self._wall_t0 = self._now_fn() if self.clock == "wall" else 0.0
        self._wall_folded = 0       # cycles removed by clock rebases
        self.dispatch = dispatch
        self.admit_dispatch = admit_dispatch
        self.n_shards = c.n_shards
        self.sets_per_shard = geometry.sets_per_shard(c.n_sets, c.n_shards)
        # ("sets",) mesh placement: under "auto" one partition per mesh
        # device (sharding only relabels who stores a set, so coarsening
        # co-located shards into one partition changes no result); with
        # one device every shard co-locates in one partition.  "fanout"
        # keeps one partition per logical shard.
        devs = (mesh_mod.default_devices(device) if devices is None
                else tuple(resolve_device(d) for d in devices))
        if not devs:
            raise ValueError("devices must name at least one device")
        self.set_mesh = mesh_mod.make_set_mesh(c.n_shards, devs)
        if dispatch == "fanout":
            self.n_parts = c.n_shards
            self._devices = (mesh_mod.set_shard_devices(self.set_mesh,
                                                        c.n_shards)
                             or [devs[0]] * c.n_shards)
        elif self.set_mesh is None:
            self.n_parts = 1
            self._devices = [devs[0]]
        else:
            self.n_parts = self.set_mesh.size
            self._devices = list(self.set_mesh.devices)
        self.device = self._devices[0]
        # the partitions' devices as a mesh (one position per partition,
        # also under "fanout"): where global views split and knobs go
        self._placement = mesh_mod.Mesh(("sets",), (self.n_parts,),
                                        tuple(self._devices))
        self.sets_per_part = c.n_sets // self.n_parts
        s_loc = self.sets_per_part
        self.plane_format = resolve_plane_format(c.plane_format)
        if self.plane_format == "packed8" and c.key_bits % 8 != 0:
            raise ValueError(
                f"plane_format='packed8' needs key_bits divisible by 8, "
                f"got key_bits={c.key_bits}")
        self.plane_rows = (c.key_bits if self.plane_format == "int8"
                           else c.key_bits // 8)
        plane_dtype = torch.int8 if self.plane_format == "int8" else torch.uint8
        parts = lambda shape, dt: [
            torch.zeros(shape, dtype=dt, device=dev) for dev in self._devices]
        self._bits = parts((s_loc, self.plane_rows, c.set_ways), plane_dtype)
        self._valid = parts((s_loc, c.set_ways), torch.int8)
        self._fp_of = parts((s_loc, c.set_ways), torch.int32)
        self._read_after = parts((s_loc, c.set_ways), torch.int32)
        self._set_writes = parts((s_loc,), torch.int32)
        self._counters = parts((s_loc,), torch.int32)
        # §8 wear state with serving knobs: window = window_ops, budget =
        # set_ways * m_writes, every rotate signal disabled (wr_shift=32:
        # int32 MSB distances never reach 32) — which is what makes the
        # vectorized record_write_rows exact.  One state per partition,
        # over that partition's sets, on its device; the knobs and the
        # no-allocate threshold are placed once on each distinct device,
        # so a batch's dispatch moves none of them.
        self.wear_cfg = wear.WearConfig(
            n_supersets=c.n_sets, m_writes=c.m_writes,
            dc_limit=1 << 30, wc_limit=1 << 30, wr_shift=32,
            t_mww_cycles=c.window_ops, blocks_per_superset=c.set_ways,
            clock=c.clock)
        self.wear_dyn = wear.dyn_of(self.wear_cfg, self.device)
        self._wear_states = wear.shard_states(self.wear_cfg, self.n_parts,
                                              self._devices)
        dyns = mesh_mod.replicated_sharding(self._placement, self.wear_dyn)
        after = mesh_mod.replicated_sharding(
            self._placement,
            torch.tensor(c.admit_after_reads, dtype=torch.int32))
        self._wear_dyns = [dyns[dev] for dev in self._devices]
        self._admit_after = [after[dev] for dev in self._devices]
        # Host-side policy shadow (map + mirrors).
        self.valid_np = np.zeros((c.n_sets, c.set_ways), bool)
        self.fp_of_np = np.zeros((c.n_sets, c.set_ways), np.uint32)
        self.slot_of = {}           # fp -> (set, way)
        self.first_touch = {}       # fp -> touch count (pre-admission)
        self.offset = 0             # rotary set offset
        self.ops_total = 0          # op counter == t_MWW cycle proxy
        self.stats = KVIndexStats()

    def _put(self, x: np.ndarray, k: int) -> torch.Tensor:
        """Place a host array on partition k's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self._devices[k])

    def _part_state(self, k: int) -> dict:
        return {"bits": self._bits[k], "valid": self._valid[k],
                "fp_of": self._fp_of[k], "read_after": self._read_after[k],
                "set_writes": self._set_writes[k],
                "counter": self._counters[k]}

    bits = _shard_property("_bits", "stored-bit planes, global view")
    valid = _shard_property("_valid", "validity planes, global view")
    fp_of = _shard_property("_fp_of", "fingerprint planes, global view")
    read_after = _shard_property(
        "_read_after", "D̄&R̄ re-read counters, global view")
    set_writes = _shard_property(
        "_set_writes", "per-set install counters, global view",
        settable=False)
    counter = _shard_property(
        "_counters", "per-set replacement counters, global view",
        settable=False)

    @property
    def wear_state(self) -> wear.WearState:
        """Global §8 wear view: THE partition's state with one partition,
        else the per-set fields concatenated in partition order
        (``wear.concat_states``) — reporting only."""
        return wear.concat_states(self._wear_states)

    # ------------------------------------------------------------------
    def _set_of(self, fps: np.ndarray) -> np.ndarray:
        """Physical set of each fingerprint under the rotary offset."""
        base = murmur3_np(fps) % np.uint32(self.cfg.n_sets)
        return ((base.astype(np.int64) + self.offset) % self.cfg.n_sets
                ).astype(np.int32)

    def _bitcols(self, fps: np.ndarray) -> np.ndarray:
        """Install columns in the plane format: ``(B, key_bits)`` int8 bit
        rows, or ``(B, key_bits // 8)`` uint8 packed words."""
        cols = xam_ops.words_to_bits_np(fps, self.cfg.key_bits)
        if self.plane_format == "packed8":
            return pack_bits_np(cols, axis=-1)
        return cols

    def _clock_cycles(self) -> int:
        """Current t_MWW cycle stamp: the op counter under ``clock="ops"``,
        elapsed wall microseconds (minus rebased folds) under "wall"."""
        if self.clock == "ops":
            return self.ops_total
        return (int((self._now_fn() - self._wall_t0) * wear.WALL_HZ)
                - self._wall_folded)

    def _maybe_rebase_clock(self):
        """Fold the t_MWW clock before the int32 cycle domain wraps
        (stamps shift in lockstep, so no decision changes)."""
        if self._clock_cycles() < wear.CLOCK_REBASE_AT:
            return
        self._wear_states = [wear.rebase_clock(ws, wear.CLOCK_REBASE_AT)
                             for ws in self._wear_states]
        if self.clock == "ops":
            self.ops_total -= wear.CLOCK_REBASE_AT
        else:
            self._wall_folded += wear.CLOCK_REBASE_AT

    def fingerprints(self, tokens: np.ndarray) -> np.ndarray:
        """(B, S) tokens -> (B, S//16) uint32 chunk fingerprints under the
        configured scheme; every caller that feeds fingerprints back to
        this index hashes through here."""
        if self.cfg.fingerprint == "prefix":
            return prefix_fingerprint_blocks(tokens, CHUNK_TOKENS)
        return fingerprint_blocks(tokens, CHUNK_TOKENS)

    def lookup(self, tokens: np.ndarray) -> np.ndarray:
        """(B, S) tokens -> (B, S // 16) bool: True where the chunk is
        cached.  ONE search for the whole batch: one fused launch, or one
        grouping and one launch per partition on its device (one launch
        per shard holding queries on the ``"fanout"`` oracle)."""
        self._maybe_rebase_clock()
        fps = self.fingerprints(tokens)
        flat = fps.reshape(-1)
        self.stats.lookups += 1
        if flat.size == 0:
            return np.zeros(fps.shape, bool)
        sets = self._set_of(flat)
        key_bits = xam_ops.words_to_bits_np(
            flat.astype(np.uint32), self.cfg.key_bits)
        if self.n_parts == 1:
            ways = xam_ops.xam_search_multiset(key_bits, sets, self._bits[0],
                                               self._valid[0])
            self.stats.searches += 1
        elif self.dispatch == "auto":
            ways = xam_ops.xam_search_multiset_stacked(
                key_bits, sets, self._bits, self._valid)
            self.stats.searches += 1
        else:
            ways = xam_ops.xam_search_multiset_sharded(
                key_bits, sets, self._bits, self._valid)
            self.stats.searches += len(np.unique(sets // self.sets_per_part))
        hit = ways >= 0
        self.stats.chunk_hits += int(hit.sum())
        self.stats.chunk_misses += int((~hit).sum())
        self.ops_total += int(flat.shape[0])   # t_MWW cycle proxy advances
        return hit.reshape(fps.shape)

    # ------------------------------------------------------------------
    def admit(self, tokens: np.ndarray):
        """Offer a batch's chunks for admission (unique fingerprints)."""
        fps = np.unique(self.fingerprints(tokens).reshape(-1))
        self.admit_fps(fps)

    def admit_fps(self, fps: np.ndarray):
        """Batched admission of (unique, order-preserved) uint32
        fingerprints: one round-grid dispatch (the per-partition scans on
        ``admit_dispatch="fanout"``), one host transfer of the decisions,
        then the host shadow-map and slab-store fold in batch order, and
        a rotation when the admission count crosses a ``rotate_every``
        multiple.  Both dispatches equal admitting the fingerprints one
        at a time in batch order, at any shard count."""
        fps = np.asarray(fps, np.uint32)
        b = int(fps.size)
        if b == 0:
            return
        self._maybe_rebase_clock()
        sets = self._set_of(fps)
        touches = np.asarray(
            [self.first_touch.get(int(fp), 0) for fp in fps], np.int32)
        bitcols = self._bitcols(fps)
        # t_MWW stamps, once per batch on the host: op clock = each
        # candidate's global batch position; wall clock = one stamp.
        if self.clock == "ops":
            cycles = (self.ops_total + np.arange(b)).astype(np.int32)
        else:
            cycles = np.full(b, self._clock_cycles(), np.int32)
        admit = (self._admit_stacked if self.admit_dispatch == "auto"
                 else self._admit_fanout)
        skip, thr, inst, way, evict, old_fp = admit(
            fps, sets, touches, bitcols, cycles)
        self.ops_total += b

        # Host shadow-map fold, in batch order; the slab store folds in
        # lockstep (victim slabs drop, installs/refreshes commit, skips
        # and throttles discard).
        store = self.slab_store
        for i in range(b):
            if evict[i]:
                self.slot_of.pop(int(old_fp[i]), None)
                if store is not None:
                    store.drop(int(old_fp[i]))
            fp = int(fps[i])
            was_resident = fp in self.slot_of
            if skip[i]:
                self.first_touch[fp] = self.first_touch.get(fp, 0) + 1
            if inst[i]:
                s, w = int(sets[i]), int(way[i])
                self.slot_of[fp] = (s, w)
                self.first_touch.pop(fp, None)
                self.valid_np[s, w] = True
                self.fp_of_np[s, w] = fps[i]
            if store is not None:
                if inst[i] or was_resident:
                    store.commit(fp)
                else:
                    store.discard(fp)
        batch_installs = int(inst.sum())
        self.stats.admissions += batch_installs
        self.stats.admission_skips += int(skip.sum())
        self.stats.evictions += int(evict.sum())
        self.stats.throttled += int(thr.sum())

        # Rotate when the admission count crosses a rotate_every multiple
        # (at most one remap per admit call, at the batch boundary).
        prev = self.stats.admissions - batch_installs
        if (self.stats.admissions // self.cfg.rotate_every
                > prev // self.cfg.rotate_every):
            self._rotate()

    def _admit_stacked(self, fps, sets, touches, bitcols, cycles):
        """ONE dispatch over the round grid of ``group_admits_stacked``:
        each partition's candidates are uploaded to its device in round
        order (the grid's padding lanes are never uploaded) and admitted
        by its own rounds (:func:`_admit_round`), round r issued on every
        partition before round r + 1 so that partitions on different
        cards overlap; each partition's decisions return to the host in
        one transfer, after every launch, and go back to batch order."""
        c = self.cfg
        part_of, row, _, _, _ = xam_ops.group_admits_stacked(
            sets, c.n_sets, self.n_parts, lo=ADMIT_BUCKET_LO)
        xam_ops.count_launch("ADMIT_LAUNCH_COUNT")
        self.stats.admit_calls += 1
        jobs = []
        for k in range(self.n_parts):
            sel = np.nonzero(part_of == k)[0]
            if sel.size == 0:
                continue
            # round-major, batch order within a round
            order = sel[np.argsort(row[sel], kind="stable")]
            bounds = np.concatenate([[0], np.cumsum(np.bincount(row[order]))])
            rounds = [slice(int(lo), int(hi))
                      for lo, hi in zip(bounds[:-1], bounds[1:])]
            lanes = tuple(self._put(x, k) for x in (
                sets[order] - k * self.sets_per_part,
                fps[order].view(np.int32), bitcols[order], cycles[order],
                touches[order]))
            outs = {key: torch.empty(order.size, dtype=dt,
                                     device=self._devices[k])
                    for key, dt in (("is_res", torch.bool),
                                    ("skipped", torch.bool),
                                    ("throttled", torch.bool),
                                    ("install", torch.bool),
                                    ("way", torch.int32),
                                    ("evict", torch.bool),
                                    ("old_fp", torch.int32))}
            jobs.append((k, order, rounds, lanes, outs))
        for r in range(max(len(job[2]) for job in jobs)):
            for k, _, rounds, lanes, outs in jobs:
                if r < len(rounds):
                    self._wear_states[k] = _admit_round(
                        self._part_state(k), self._wear_states[k],
                        self._wear_dyns[k], self._admit_after[k], rounds[r],
                        *lanes, outs)
        res = {}
        for _, order, _, _, outs in jobs:
            for key, v in outs.items():
                v = v.cpu().numpy()
                if key not in res:
                    res[key] = np.empty(sets.shape[0], v.dtype)
                res[key][order] = v
        return (res["skipped"], res["throttled"], res["install"], res["way"],
                res["evict"], res["old_fp"].view(np.uint32))

    def _admit_fanout(self, fps, sets, touches, bitcols, cycles):
        """The per-partition oracle (``admit_dispatch="fanout"``): the
        candidates grouped by owning partition (batch order kept within
        each, cycle stamps keeping their global batch position), one
        :func:`_admit_batch` scan per partition holding candidates, the
        decisions scattered back to batch order so the host fold in
        :meth:`admit_fps` is shared."""
        b = int(fps.size)
        part = sets // self.sets_per_part
        res = {"skipped": np.zeros(b, bool), "throttled": np.zeros(b, bool),
               "install": np.zeros(b, bool), "way": np.zeros(b, np.int32),
               "evict": np.zeros(b, bool), "old_fp": np.zeros(b, np.int32)}
        launches = []
        for k in np.unique(part):
            k = int(k)
            sel = np.nonzero(part == k)[0]
            self._wear_states[k], outs = _admit_batch(
                self._part_state(k), self._wear_states[k],
                self._wear_dyns[k], self._admit_after[k],
                self._put(sets[sel] - k * self.sets_per_part, k),
                self._put(fps[sel].view(np.int32), k),
                self._put(bitcols[sel], k), self._put(cycles[sel], k),
                self._put(touches[sel], k))
            xam_ops.count_launch("ADMIT_LAUNCH_COUNT")
            self.stats.admit_calls += 1
            launches.append((sel, outs))
        for sel, outs in launches:
            for key, v in res.items():
                v[sel] = outs[key].cpu().numpy()
        return (res["skipped"], res["throttled"], res["install"], res["way"],
                res["evict"], res["old_fp"].view(np.uint32))

    def _rotate(self):
        """Rotary remap (prime stride 7): roll the set planes by the
        global permutation ``set -> set + 7 (mod n_sets)`` while the
        ``_set_of`` offset moves in lockstep.  One partition: one roll on
        its device.  Several under ``"auto"``: the boundary exchange of
        ``mesh.make_sharded_roll`` (the reference's ``ppermute``), every
        new block built before any is rebound, no plane data through the
        host.  The ``"fanout"`` oracle rolls through the global views:
        the getter concatenates, the setter re-splits.  Wear and
        replacement counters track PHYSICAL sets and stay.  An
        ``AdmitQueue`` drains first."""
        n = self.cfg.n_sets
        shift = ROTATE_STRIDE % n
        self.offset = (self.offset + ROTATE_STRIDE) % n
        self.stats.rotations += 1
        if shift:
            if self.n_parts > 1 and self.dispatch == "auto":
                roll = mesh_mod.make_sharded_roll(self.set_mesh, n, shift)
                (self._bits, self._valid, self._fp_of,
                 self._read_after) = roll(self._bits, self._valid,
                                          self._fp_of, self._read_after)
            else:
                for name in ("bits", "valid", "fp_of", "read_after"):
                    setattr(self, name,
                            torch.roll(getattr(self, name), shift, dims=0))
            self.valid_np = np.roll(self.valid_np, shift, axis=0)
            self.fp_of_np = np.roll(self.fp_of_np, shift, axis=0)
            self.slot_of = {fp: ((s + shift) % n, w)
                            for fp, (s, w) in self.slot_of.items()}

    # ------------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        t = self.stats.chunk_hits + self.stats.chunk_misses
        return self.stats.chunk_hits / max(t, 1)

    def slab_lockstep_report(self) -> dict:
        """``{"missing_slabs": [...], "orphan_slabs": [...]}``: resident
        fingerprints without a slab, and slabs whose fingerprint the index
        no longer holds (a lockstep violation).  Both empty when every
        admission staged a slab."""
        if self.slab_store is None:
            return {"missing_slabs": [], "orphan_slabs": []}
        indexed = {int(fp) for fp in self.slot_of}
        resident = self.slab_store.resident_fps()
        return {"missing_slabs": sorted(indexed - resident),
                "orphan_slabs": sorted(resident - indexed)}

    def write_distribution(self) -> np.ndarray:
        """Installs per PHYSICAL set — the wear-evenness metric."""
        return self.set_writes.cpu().numpy()

    def wear_report(self) -> dict:
        """Serving-side §8 wear stats (as in the reference):
        ``installs_per_set_max/mean``, ``skew_max_over_mean``,
        ``window_writes``, ``throttled_sets_now`` and the throttle/rotation
        stats."""
        w = self.write_distribution().astype(np.float64)
        mean = float(w.mean()) if w.size else 0.0
        cyc = min(self._clock_cycles(), 2 ** 31 - 1)
        throttled_now = sum(
            int(wear.window_would_exceed(
                self._wear_states[k], self._wear_dyns[k],
                torch.arange(self.sets_per_part, device=self._devices[k]),
                cyc).sum())
            for k in range(self.n_parts))
        return {
            "installs_per_set_max": float(w.max()) if w.size else 0.0,
            "installs_per_set_mean": mean,
            "skew_max_over_mean": float(w.max() / mean) if mean > 0 else 1.0,
            "window_writes": self.wear_state.window_writes.cpu().tolist(),
            "throttled_sets_now": throttled_now,
            "throttled": self.stats.throttled,
            "rotations": self.stats.rotations,
        }

    def lifetime_estimate(self, endurance: float = 1e8,
                          ops_per_second: float = 1e6
                          ) -> lifetime_mod.LifetimeResult:
        """Fig. 11-style lifetime projection from the install counters."""
        return lifetime_mod.estimate_from_ops(
            self.write_distribution(), self.ops_total,
            self.stats.rotations, endurance=endurance,
            ops_per_second=ops_per_second)
