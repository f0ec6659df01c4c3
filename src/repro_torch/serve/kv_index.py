"""MonarchKVIndex on one device — port of ``repro/serve/kv_index.py``
(single partition).

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
  :func:`_admit_rounds` admits round after round, each round vectorized
  over its lanes: residency probe, no-allocate gate, t_MWW throttle
  (``core/wear.py``), cold-victim way selection, column install and wear
  recording.  Bit-equal to admitting one fingerprint at a time in batch
  order.  The decisions come back to the host in one transfer, which is
  the only synchronisation of an admission.
* ROTATION: every ``rotate_every`` admissions the planes roll by the
  prime stride 7 in lockstep with the ``_set_of`` offset, so resident
  entries stay searchable.

All index state lives on ``device`` and changes in place, where the
reference donated its buffers.  The fingerprint plane is stored as int32
(the bit pattern of the uint32 fingerprint — torch's uint32 support is
partial); equality is all the index asks of it, and every report views it
back as uint32.  Lookups (serving thread) and admissions (``AdmitQueue``
worker) both run on the device's default stream, so the card orders them.

``n_shards > 1`` and the ``"fanout"`` dispatch paths are not ported yet
(ROADMAP.md, port queue: multi-GPU index paths).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import lifetime as lifetime_mod
from repro_torch.core import wear
from repro_torch.core.timing import SECONDS_PER_YEAR, t_mww_seconds
from repro_torch.data.pipeline import (fingerprint_blocks, murmur3_np,
                                       prefix_fingerprint_blocks)
from repro_torch.device import resolve_device
from repro_torch.kernels.common import pack_bits_np, resolve_plane_format
from repro_torch.kernels.xam_search import ops as xam_ops
from repro_torch.pytree import tree_leaves

CHUNK_TOKENS = 16
ROTATE_STRIDE = 7          # prime set stride per rotation (§8)
ADMIT_BUCKET_LO = 8        # pow2 bucket floor for admit batch shapes

_MULTI_GPU = ("not ported yet (ROADMAP.md, port queue: multi-GPU index "
              "paths)")


@dataclasses.dataclass
class KVIndexConfig:
    """Serving-index geometry and §8 durability knobs (fields as in the
    reference: ``n_sets`` CAM sets of ``set_ways`` columns, ``key_bits``
    fingerprint bits per column, the no-allocate threshold
    ``admit_after_reads``, the per-way write budget ``m_writes`` per
    t_MWW window of ``window_ops`` cycles in the ``clock`` domain
    ("ops" or "wall" microseconds), ``rotate_every`` admissions between
    rotary remaps, ``n_shards`` (1 in the port), ``plane_format`` ("int8"
    or "packed8"; None reads ``REPRO_PLANE_FORMAT``) and the chunk
    ``fingerprint`` scheme ("block" or "prefix")."""
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
    searches: int = 0             # lookup launches (1 per batch)
    admit_calls: int = 0          # admission dispatches (1 per batch)


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


def _admit_rounds(st: dict, ws: wear.WearState, wdyn: wear.WearDyn,
                  admit_after: int, rounds: list[slice], sets, fps, bitcols,
                  cycles, touches):
    """Segmented-parallel admission over the round grid (one partition).

    ``sets``/``fps`` (int32 view)/``bitcols``/``cycles``/``touches`` are
    the batch's candidates on the device, ordered by round; ``rounds[r]``
    slices round r's lanes, whose sets are pairwise distinct.  Every lane
    is a real candidate (the host drops the grid's padding before
    upload), so each write below targets a distinct (set, way) and
    nothing collides.  Updates the planes in ``st`` in place (the
    reference donated them) and returns ``(wear_state, outs)`` with the
    per-candidate decision tensors in round order."""
    bits, valid, fp_of, read_after = (st["bits"], st["valid"], st["fp_of"],
                                      st["read_after"])
    n_ways = valid.shape[1]
    dev = valid.device
    iota = torch.arange(n_ways, dtype=torch.int32, device=dev)
    b = sets.shape[0]
    outs = {k: torch.empty(b, dtype=dt, device=dev) for k, dt in (
        ("is_res", torch.bool), ("skipped", torch.bool),
        ("throttled", torch.bool), ("install", torch.bool),
        ("way", torch.int32), ("evict", torch.bool),
        ("old_fp", torch.int32))}
    for lanes in rounds:
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
    return ws, outs


class MonarchKVIndex:
    """Monarch flat-CAM prefix index on one device (see module docstring).

    Parameters
    ----------
    cfg : KVIndexConfig, optional
        Geometry/durability knobs; default-constructed per instance.
    dispatch, admit_dispatch : str
        Only ``"auto"`` (and ``None`` for ``admit_dispatch``) is ported.
    now_fn : callable, optional
        Wall-clock source for ``clock="wall"`` configs (monotonic seconds;
        default ``time.monotonic``).  Never consulted under ``clock="ops"``.
    slab_store : KVSlabStore, optional
        Kept in lockstep by the admission fold.
    device : str or torch.device
        Where the index planes live; default ``"cuda"`` (raises when no
        card is visible).

    Attributes
    ----------
    bits, valid, fp_of, read_after, set_writes, counter : torch.Tensor
        The CAM state on ``device``: ``(n_sets, key_bits, set_ways)`` int8
        stored bits (``(n_sets, key_bits // 8, set_ways)`` uint8 packed
        words under ``plane_format="packed8"``), ``(n_sets, set_ways)``
        validity (int8), fingerprint (int32 holding the uint32 bit
        pattern) and D̄&R̄ (int32) planes, and the ``(n_sets,)`` int32
        install and replacement counters.

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
                 device: str | torch.device = "cuda"):
        self.cfg = KVIndexConfig() if cfg is None else cfg
        c = self.cfg
        if dispatch != "auto" or admit_dispatch not in (None, "auto"):
            raise NotImplementedError(
                f"dispatch={dispatch!r}/admit_dispatch={admit_dispatch!r}: "
                f"the 'fanout' reference paths are {_MULTI_GPU}")
        if c.n_shards != 1:
            raise NotImplementedError(
                f"n_shards={c.n_shards}: the sharded index is {_MULTI_GPU}")
        if c.clock not in wear.CLOCKS:
            raise ValueError(
                f"KVIndexConfig.clock={c.clock!r}: expected one of "
                f"{wear.CLOCKS}")
        if c.fingerprint not in ("block", "prefix"):
            raise ValueError(
                f"KVIndexConfig.fingerprint={c.fingerprint!r}: expected "
                "'block' or 'prefix'")
        self.device = resolve_device(device)
        self.slab_store = slab_store
        self.clock = c.clock
        self._now_fn = time.monotonic if now_fn is None else now_fn
        self._wall_t0 = self._now_fn() if self.clock == "wall" else 0.0
        self._wall_folded = 0       # cycles removed by clock rebases
        self.plane_format = resolve_plane_format(c.plane_format)
        if self.plane_format == "packed8" and c.key_bits % 8 != 0:
            raise ValueError(
                f"plane_format='packed8' needs key_bits divisible by 8, "
                f"got key_bits={c.key_bits}")
        self.plane_rows = (c.key_bits if self.plane_format == "int8"
                           else c.key_bits // 8)
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        plane_dtype = torch.int8 if self.plane_format == "int8" else torch.uint8
        self.bits = z((c.n_sets, self.plane_rows, c.set_ways), plane_dtype)
        self.valid = z((c.n_sets, c.set_ways), torch.int8)
        self.fp_of = z((c.n_sets, c.set_ways), torch.int32)
        self.read_after = z((c.n_sets, c.set_ways), torch.int32)
        self.set_writes = z((c.n_sets,), torch.int32)
        self.counter = z((c.n_sets,), torch.int32)
        # §8 wear state with serving knobs: window = window_ops, budget =
        # set_ways * m_writes, every rotate signal disabled (wr_shift=32:
        # int32 MSB distances never reach 32) — which is what makes the
        # vectorized record_write_rows exact.
        self.wear_cfg = wear.WearConfig(
            n_supersets=c.n_sets, m_writes=c.m_writes,
            dc_limit=1 << 30, wc_limit=1 << 30, wr_shift=32,
            t_mww_cycles=c.window_ops, blocks_per_superset=c.set_ways,
            clock=c.clock)
        self.wear_dyn = wear.dyn_of(self.wear_cfg, self.device)
        self.wear_state = wear.init_state(self.wear_cfg, self.device)
        # Host-side policy shadow (map + mirrors).
        self.valid_np = np.zeros((c.n_sets, c.set_ways), bool)
        self.fp_of_np = np.zeros((c.n_sets, c.set_ways), np.uint32)
        self.slot_of = {}           # fp -> (set, way)
        self.first_touch = {}       # fp -> touch count (pre-admission)
        self.offset = 0             # rotary set offset
        self.ops_total = 0          # op counter == t_MWW cycle proxy
        self.stats = KVIndexStats()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

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
        self.wear_state = wear.rebase_clock(self.wear_state,
                                            wear.CLOCK_REBASE_AT)
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
        cached.  ONE fused search launch for the whole batch."""
        self._maybe_rebase_clock()
        fps = self.fingerprints(tokens)
        flat = fps.reshape(-1)
        self.stats.lookups += 1
        if flat.size == 0:
            return np.zeros(fps.shape, bool)
        sets = self._set_of(flat)
        key_bits = xam_ops.words_to_bits_np(
            flat.astype(np.uint32), self.cfg.key_bits)
        ways = xam_ops.xam_search_multiset(key_bits, sets, self.bits,
                                           self.valid)
        self.stats.searches += 1
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
        fingerprints: one round-grid dispatch, one host transfer of the
        decisions, then the host shadow-map and slab-store fold in batch
        order, and a rotation when the admission count crosses a
        ``rotate_every`` multiple."""
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
        skip, thr, inst, way, evict, old_fp = self._admit_stacked(
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
        candidates are uploaded in round order (the grid's padding lanes
        are never uploaded), admitted by :func:`_admit_rounds`, and the
        decisions return to the host in one transfer, in batch order."""
        c = self.cfg
        _, row, _, _, _ = xam_ops.group_admits_stacked(
            sets, c.n_sets, 1, lo=ADMIT_BUCKET_LO)
        order = np.argsort(row, kind="stable")     # round-major, batch order
        bounds = np.concatenate([[0], np.cumsum(np.bincount(row))])
        rounds = [slice(int(lo), int(hi))
                  for lo, hi in zip(bounds[:-1], bounds[1:])]
        xam_ops.count_launch("ADMIT_LAUNCH_COUNT")
        self.stats.admit_calls += 1
        st = {"bits": self.bits, "valid": self.valid, "fp_of": self.fp_of,
              "read_after": self.read_after, "set_writes": self.set_writes,
              "counter": self.counter}
        self.wear_state, outs = _admit_rounds(
            st, self.wear_state, self.wear_dyn, c.admit_after_reads, rounds,
            self._put(sets[order]), self._put(fps[order].view(np.int32)),
            self._put(bitcols[order]), self._put(cycles[order]),
            self._put(touches[order]))
        # One transfer for the whole batch; un-permute to batch order.
        host = {k: v.cpu().numpy() for k, v in outs.items()}
        res = {}
        for k, v in host.items():
            res[k] = np.empty_like(v)
            res[k][order] = v
        return (res["skipped"], res["throttled"], res["install"], res["way"],
                res["evict"], res["old_fp"].view(np.uint32))

    def _rotate(self):
        """Rotary remap (prime stride 7): roll the set planes by the
        permutation ``set -> set + 7 (mod n_sets)`` while the ``_set_of``
        offset moves in lockstep.  Wear/replacement counters track
        PHYSICAL sets and stay.  An ``AdmitQueue`` drains first."""
        n = self.cfg.n_sets
        shift = ROTATE_STRIDE % n
        self.offset = (self.offset + ROTATE_STRIDE) % n
        self.stats.rotations += 1
        if shift:
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
        throttled_now = int(wear.window_would_exceed(
            self.wear_state, self.wear_dyn,
            torch.arange(self.cfg.n_sets, device=self.device), cyc).sum())
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
