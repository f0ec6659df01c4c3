"""Hopscotch hash table (paper §9.2.2) with a Monarch-accelerated lookup
(port of ``repro/apps/hashtable.py``).

Open addressing with windowed (neighborhood) probing:

* ``insert``: home = hash(key) % n; store in a free bucket of the
  H-window, else walk forward for a free bucket and hop it backwards by
  moving window-compatible keys; rehash to 2x on failure.
* ``lookup_baseline``: probe up to H buckets serially (up to H reads).
* ``lookup_monarch``: ONE window search per key — the hopscotch window
  maps onto a CAM set search (``kernels/hopscotch``, a Hopper kernel on
  the card).

The table reports operation counts (probes, searches, writes, swaps,
rehashes), the inputs of the §10.4 timing model.

Two storage backends share every code path above the bucket store:

* ``backend="host"``: numpy uint64 buckets, the reference; the lookup
  kernel reads a device mirror of the key planes, uploaded again after
  every change of the keys (O(n) host-to-device bytes per insert on the
  card, as in the reference; fill large tables through the device
  backend).
* ``backend="device"``: the table lives on the device as four (n + 2H,)
  int32 planes (key lo/hi, value lo/hi, uint32 bit patterns);
  ``insert``/``delete`` update them in place
  (``kernels.hopscotch.ops.hopscotch_insert_device``) and the host keeps
  a lazy mirror for the rehash and baseline paths.

Stats and the §8 wear record are identical between the backends and to
the reference (the device insert returns the touched buckets in host
``_record_write`` order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lifetime, wear
from repro_torch.data.pipeline import murmur3_np
from repro_torch.device import resolve_device
from repro_torch.kernels.common import bucket_pow2, resolve_plane_format
from repro_torch.kernels.hopscotch import ops as hop_ops

EMPTY = np.uint64(0)
WEAR_FLUSH_EVERY = 256      # bucket writes buffered per wear update
_LO = np.uint64(0xFFFFFFFF)


@dataclasses.dataclass
class HashStats:
    lookups: int = 0
    probes: int = 0           # baseline bucket reads
    searches: int = 0         # Monarch window searches
    data_reads: int = 0
    inserts: int = 0
    insert_probes: int = 0
    swaps: int = 0
    rehashes: int = 0
    writes: int = 0
    deletes: int = 0


def _halves(x: np.ndarray):
    """uint64 values -> (lo, hi) int32 bit patterns of their halves."""
    x = np.asarray(x, np.uint64)
    return ((x & _LO).astype(np.uint32).view(np.int32),
            (x >> np.uint64(32)).astype(np.uint32).view(np.int32))


def _join(lo: torch.Tensor, hi: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern halves on any device -> uint64 values."""
    lo = lo.cpu().numpy().view(np.uint32).astype(np.uint64)
    hi = hi.cpu().numpy().view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


class HopscotchTable:
    def __init__(self, log2_size: int, window: int = 32, seed: int = 0,
                 wear_cfg: wear.WearConfig | None = None,
                 backend: str = "host", plane_format: str | None = None,
                 device: str | torch.device = "cuda"):
        """``wear_cfg``: optional §8 wear accounting over the table's
        backing store; bucket writes are charged to ``n_supersets`` equal
        stripes through ``wear.record_writes``, buffered and applied in
        batches.  ``backend``: ``"host"`` or ``"device"`` (see the module
        docstring).  ``plane_format`` is validated and changes nothing:
        the key planes are uint32 words, already 8 bits per byte.
        ``device``: where the lookup kernel, the device planes and the
        wear state live (default ``"cuda"``; raises without a card)."""
        if backend not in ("host", "device"):
            raise ValueError(
                f"backend must be one of ('host', 'device'), got "
                f"{backend!r}")
        self.plane_format = resolve_plane_format(plane_format)
        self.device = resolve_device(device)
        self.backend = backend
        self.window = window
        self.wear_cfg = wear_cfg
        if wear_cfg is not None:
            self.wear_state = wear.init_state(wear_cfg, self.device)
            self.wear_dyn = wear.dyn_of(wear_cfg, self.device)
            self.writes_per_superset = np.zeros(
                wear_cfg.n_supersets, np.int64)
            self._pending_ss: list[int] = []
            self._wear_rotates = 0
            self._wear_op = 0
        self._alloc(1 << log2_size)
        self.stats = HashStats()

    def _alloc(self, n: int):
        self.n = n
        # +2 windows of pad so windows never wrap.
        self.keys = np.zeros(n + 2 * self.window, np.uint64)
        self.vals = np.zeros(n + 2 * self.window, np.uint64)
        self._table_version = getattr(self, "_table_version", 0) + 1
        self._dev_planes = None     # (version, t_lo, t_hi) host-backend mirror
        if self.backend == "device":
            # the authoritative store: key lo/hi, value lo/hi planes
            self._pk_lo, self._pk_hi, self._pv_lo, self._pv_hi = (
                torch.zeros(n + 2 * self.window, dtype=torch.int32,
                            device=self.device) for _ in range(4))
            self._host_dirty = False   # keys/vals mirror is in sync
        if self.wear_cfg is not None:
            # superset stripe width over the (padded) bucket array
            self._ss_stripe = -(-len(self.keys) // self.wear_cfg.n_supersets)

    # ------------------------------------------------------------------
    # §8 wear accounting.
    # ------------------------------------------------------------------
    def _record_write(self, bucket: int):
        if self.wear_cfg is None:
            return
        ss = min(int(bucket) // self._ss_stripe, self.wear_cfg.n_supersets - 1)
        self.writes_per_superset[ss] += 1
        self._pending_ss.append(ss)
        if len(self._pending_ss) >= WEAR_FLUSH_EVERY:
            self.flush_wear()

    def flush_wear(self):
        """Apply buffered bucket writes to the wear state in one
        ``wear.record_writes`` call: a pow2-bucketed trace (floor 32) with
        an ``active`` mask, every write dirty, the op clock folded by
        ``wear.maybe_rebase`` before the int32 cycle domain wraps."""
        if self.wear_cfg is None or not self._pending_ss:
            return
        self.wear_state, self._wear_op = wear.maybe_rebase(
            self.wear_state, self._wear_op)
        n = len(self._pending_ss)
        nb = bucket_pow2(n, lo=32)
        ss = np.zeros(nb, np.int32)
        ss[:n] = self._pending_ss
        cycles = (self._wear_op + np.arange(nb)).astype(np.int32)
        active = np.zeros(nb, bool)
        active[:n] = True
        self.wear_state, rotated, _fl = wear.record_writes(
            self.wear_state, self.wear_dyn, ss, np.ones(nb, bool), cycles,
            active)
        self._wear_rotates += int(rotated.sum())
        self._wear_op += n
        self._pending_ss = []

    def _require_wear(self, what: str):
        if self.wear_cfg is None:
            raise ValueError(
                f"{what} requires wear tracking; construct the table with "
                "a wear_cfg (see repro_torch.core.wear.WearConfig)")

    def wear_report(self) -> dict:
        """Wear summary for benchmarks/launchers (flushes first)."""
        self._require_wear("wear_report()")
        self.flush_wear()
        w = self.writes_per_superset.astype(np.float64)
        mean = float(w.mean()) if w.size else 0.0
        return {
            "writes_total": int(w.sum()),
            "writes_per_superset_max": float(w.max()) if w.size else 0.0,
            "skew_max_over_mean": float(w.max() / mean) if mean > 0 else 1.0,
            "rotates": self._wear_rotates,
            "locked_now": int(
                (self.wear_state.locked_until > self._wear_op).sum()),
        }

    def lifetime_estimate(self, endurance: float = 1e8,
                          ops_per_second: float = 1e6):
        """Fig. 11-style lifetime projection for the table's write stream."""
        self._require_wear("lifetime_estimate()")
        self.flush_wear()
        return lifetime.estimate_from_ops(
            self.writes_per_superset, self._wear_op, self._wear_rotates,
            endurance=endurance, ops_per_second=ops_per_second)

    # ------------------------------------------------------------------
    def home(self, key) -> np.ndarray:
        return (murmur3_np(np.asarray(key, np.uint64).astype(np.uint32))
                % np.uint32(self.n)).astype(np.int64)

    @property
    def load(self) -> float:
        if self.backend == "device":
            occupied = int(((self._pk_lo != 0) | (self._pk_hi != 0)).sum())
            return float(occupied) / self.n
        return float((self.keys != EMPTY).sum()) / self.n

    def _sync_host(self):
        """Refresh the host keys/vals mirror from the device planes (device
        backend only; the rehash and baseline paths read it)."""
        if self.backend != "device" or not self._host_dirty:
            return
        self.keys = _join(self._pk_lo, self._pk_hi)
        self.vals = _join(self._pv_lo, self._pv_hi)
        self._host_dirty = False

    # ------------------------------------------------------------------
    def insert(self, key: int, val: int) -> bool:
        key = np.uint64(key)
        if key == EMPTY:
            raise ValueError("0 is the empty sentinel")
        self.stats.inserts += 1
        if self.backend == "device":
            return self._insert_device(key, np.uint64(val))
        return self._insert_host(key, np.uint64(val))

    def _insert_device(self, key: np.uint64, val: np.uint64) -> bool:
        """One device insert; its write log replays the host backend's
        exact ``_record_write`` sequence."""
        status, probes, swaps, log = hop_ops.hopscotch_insert_device(
            self._pk_lo, self._pk_hi, self._pv_lo, self._pv_hi,
            int(self.home(key)), int(key & _LO), int(key >> np.uint64(32)),
            int(val & _LO), int(val >> np.uint64(32)), window=self.window)
        self.stats.insert_probes += probes
        self.stats.swaps += swaps
        self.stats.writes += len(log)
        if log:
            self._host_dirty = True
            for slot in log:
                self._record_write(slot)
        if status == 2:
            self._rehash()
            return self.insert(int(key), int(val))
        return True

    def _insert_host(self, key: np.uint64, val: np.uint64) -> bool:
        h = int(self.home(key))
        w = self.window
        # already present? (one lookup)
        off = int(self._lookup_window(np.asarray([key]))[0])
        if off >= 0:
            self.vals[h + off] = np.uint64(val)
            self.stats.writes += 1
            self._record_write(h + off)
            return True
        # free bucket within window (probes up to the first free slot)
        win = self.keys[h:h + w]
        free = np.nonzero(win == EMPTY)[0]
        self.stats.insert_probes += int(free[0]) + 1 if free.size else w
        if free.size:
            self.keys[h + free[0]] = key
            self.vals[h + free[0]] = np.uint64(val)
            self.stats.writes += 1
            self._record_write(h + int(free[0]))
            self._table_version += 1
            return True
        # walk forward for a free bucket, then hop it back
        j = h + w
        limit = min(self.n + w, h + 64 * w)
        while j < limit and self.keys[j] != EMPTY:
            j += 1
            self.stats.insert_probes += 1
        if j >= limit:
            self._rehash()
            return self.insert(int(key), int(val))
        while j >= h + w:
            moved = False
            for k in range(j - w + 1, j):
                if k < 0:
                    continue
                kh = int(self.home(self.keys[k])) if self.keys[k] != EMPTY else -1
                if kh >= 0 and j < kh + w:
                    # key at k may legally move to j
                    self.keys[j] = self.keys[k]
                    self.vals[j] = self.vals[k]
                    self.keys[k] = EMPTY
                    self._table_version += 1
                    self.stats.swaps += 1
                    self.stats.writes += 2
                    self._record_write(j)
                    self._record_write(k)
                    j = k
                    moved = True
                    break
            if not moved:
                self._rehash()
                return self.insert(int(key), int(val))
        self.keys[j] = key
        self.vals[j] = np.uint64(val)
        self.stats.writes += 1
        self._record_write(j)
        self._table_version += 1
        return True

    def delete(self, key: int) -> bool:
        """Remove ``key`` (clears the bucket's key AND value).  Returns
        False on miss."""
        key = np.uint64(key)
        if key == EMPTY:
            raise ValueError("0 is the empty sentinel")
        self.stats.deletes += 1
        off = int(self._lookup_window(np.asarray([key]))[0])
        if off < 0:
            return False
        idx = int(self.home(key)) + off
        if self.backend == "device":
            hop_ops.hopscotch_delete_device(
                self._pk_lo, self._pk_hi, self._pv_lo, self._pv_hi, idx)
            self._host_dirty = True
        else:
            self.keys[idx] = EMPTY
            self.vals[idx] = np.uint64(0)
        self.stats.writes += 1
        self._record_write(idx)
        self._table_version += 1
        return True

    def _rehash(self):
        self.stats.rehashes += 1
        self._sync_host()
        old_k, old_v = self.keys.copy(), self.vals.copy()
        self._alloc(self.n * 2)
        for k, v in zip(old_k, old_v):
            if k != EMPTY:
                self.insert(int(k), int(v))

    # ------------------------------------------------------------------
    def _table_planes(self):
        """The key planes the lookup kernel reads: the device backend's
        own planes, or the host backend's mirror, uploaded again after
        every change of the keys.  A window [home, home + H) with
        home < n never reaches the last H pad slots, so the planes need
        no padding to a window multiple (the TPU kernel's tiles did)."""
        if self.backend == "device":
            return self._pk_lo, self._pk_hi
        if (self._dev_planes is None
                or self._dev_planes[0] != self._table_version):
            t_lo, t_hi = (torch.from_numpy(x).to(self.device)
                          for x in _halves(self.keys))
            self._dev_planes = (self._table_version, t_lo, t_hi)
        return self._dev_planes[1], self._dev_planes[2]

    def _lookup_window(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        lo, hi = _halves(keys)
        t_lo, t_hi = self._table_planes()
        out = hop_ops.hopscotch_lookup(t_lo, t_hi, self.home(keys), lo, hi,
                                       window=self.window)
        return out.cpu().numpy()

    def lookup_monarch(self, keys: np.ndarray):
        """Batched lookup through the window-search kernel: ONE search +
        (on hit) one data read per query."""
        keys = np.asarray(keys, np.uint64)
        offs = self._lookup_window(keys)
        self.stats.lookups += len(keys)
        self.stats.searches += len(keys)
        hits = offs >= 0
        self.stats.data_reads += int(hits.sum())
        idx = self.home(keys).astype(np.int64) + np.where(hits, offs, 0)
        if self.backend == "device":
            # the value gather stays on the device; only (Q,) results land
            ii = torch.from_numpy(idx).to(self.device)
            got = _join(self._pv_lo[ii], self._pv_hi[ii])
            return np.where(hits, got, np.uint64(0)), hits
        vals = np.where(hits, self.vals[idx], np.uint64(0))
        return vals, hits

    def lookup_baseline(self, keys: np.ndarray):
        """Serial window probing; counts the reads Monarch saves."""
        self._sync_host()
        keys = np.asarray(keys, np.uint64)
        self.stats.lookups += len(keys)
        vals = np.zeros(len(keys), np.uint64)
        hits = np.zeros(len(keys), bool)
        for i, key in enumerate(keys):
            h = int(self.home(key))
            for off in range(self.window):
                self.stats.probes += 1
                if self.keys[h + off] == key:
                    vals[i] = self.vals[h + off]
                    hits[i] = True
                    self.stats.data_reads += 1
                    break
                if self.keys[h + off] == EMPTY:
                    # hopscotch guarantee: an empty home-window slot means
                    # the key is absent (the metadata bitmap stops here)
                    break
        return vals, hits
