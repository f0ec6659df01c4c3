"""Asynchronous admission queue for the MonarchKVIndex (port of
``repro/serve/admit_queue.py``; the logic is the reference's, line for
line).  On the card the worker thread's admissions and the serving
thread's lookups run on the device's default stream, so the GPU orders
them; ``_idx_lock`` keeps their host sides apart, and the admission's
host fold (its one device-to-host copy) is the synchronisation point.

Inline admission puts ``admit_fps`` — a device scan plus host shadow-map
bookkeeping — on the serving loop's critical path between batches.  This
module moves it behind a queue drained by a worker thread, so installs
overlap the loop's model compute (prefill/decode): the serving thread's
model steps release the GIL inside torch while the worker runs the
admission pipeline.

Semantics:

* Submission order is preserved, and pending batches are COALESCED into
  one ``admit_fps`` call only while they stay mutually DISJOINT (and
  under ``COALESCE_MAX_FPS``).  Disjointness is what makes the merge
  exact: ``admit_fps`` latches no-allocate touch counts per call, so
  merging two offers of the SAME fingerprint would count one touch where
  inline admission counts two — the worker therefore stops merging at
  the first batch sharing a fingerprint with the unit it is building.
  For disjoint batches the concatenation is bit-exact with the separate
  calls: per-candidate cycle stamps are the global batch positions, which
  concatenate to the same sequence, and the device scan admits in the
  same order.  After ``flush()`` the index state is therefore EXACTLY
  what the same ``admit_fps`` calls issued inline would produce, with
  two documented async relaxations: the op-counter clock may differ when
  lookups interleave (shifting t_MWW cycle stamps), and an auto-rotation
  landing INSIDE a coalesced unit happens at the unit's end rather than
  between the merged batches (serving configs rotate via the explicit
  drain-barrier :meth:`rotate`, where no such window exists).  A failed
  merged unit drops ALL its batches (surfaced at the next barrier, same
  as an unmerged failure).  ``coalesce=False`` restores strict
  one-submit-one-call draining.
* The queue owns an index lock: the worker holds it across each
  ``admit_fps`` (which updates the planes in place and rebinds them on
  rotation), and :meth:`lookup` / :meth:`rotate` take it too, so the
  serving loop never searches planes mid-update.
* ``rotate()`` is a DRAIN BARRIER: the queue flushes before the remap, so
  rotation stays the lockstep plane roll — no admission can land
  mid-remap.  (Auto-rotation inside ``admit_fps``
  happens under the index lock and is ordered for free.)
* Read-your-writes: with ``read_your_writes=True`` (default),
  :meth:`lookup` flushes the queue first whenever one of the looked-up
  fingerprints is still pending/in-flight, so a request never misses on
  a chunk whose admission it (or a predecessor) already submitted.
* Back-pressure: ``max_pending`` bounds the fingerprints awaiting
  admission; at the bound, ``policy`` picks block / shed-oldest / defer
  (see :class:`AdmitQueue`).  Shedding only ever drops whole QUEUED
  batches — accepted batches still drain in submission order, so the
  coalescing exactness argument above is unchanged.

``background=False`` degrades to a synchronous shim (submit == inline
admit under the same lock) for deterministic tests and single-threaded
callers.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from repro_torch.serve.kv_index import MonarchKVIndex

#: Coalesced-unit size cap: bounds the single device dispatch a drained
#: unit turns into (and the work lost if a merged unit fails).
COALESCE_MAX_FPS = 8192


@dataclasses.dataclass
class AdmitQueueStats:
    submitted: int = 0        # fingerprints ACCEPTED by submit()
    batches: int = 0          # submitted batches drained
    coalesced: int = 0        # admit_fps dispatches saved by merging
    flushes: int = 0          # explicit/barrier flushes
    rww_flushes: int = 0      # flushes forced by read-your-writes lookups
    shed: int = 0             # pending batches dropped (policy="shed")
    shed_fps: int = 0         # fingerprints in those shed batches
    deferred: int = 0         # submits rejected (policy="defer")


class AdmitQueue:
    """Admission queue over a :class:`MonarchKVIndex`.

    Parameters
    ----------
    index : MonarchKVIndex
        The index to admit into.  All index access (lookups included)
        should go through this queue once it exists.
    background : bool
        Drain on a daemon worker thread (default).  ``False`` = drain
        synchronously inside :meth:`submit` — same semantics, no overlap.
    read_your_writes : bool
        Flush before a lookup that touches a pending fingerprint.
    coalesce : bool
        Merge consecutive pending batches into one ``admit_fps`` call
        while they stay mutually disjoint (default; see module
        docstring for why disjointness keeps the merge exact).
        ``False`` = one submit, one call.
    max_pending : int, optional
        Bound on fingerprints pending admission (queued + in flight).
        ``None`` (default) keeps the queue unbounded.  When a submit
        would push past the bound, ``policy`` decides what gives.  A
        single batch larger than the bound is still accepted once the
        queue has fully drained — the bound back-pressures, it never
        deadlocks or permanently rejects.
    policy : {"block", "shed", "defer"}
        Back-pressure at the ``max_pending`` bound.  ``"block"``: the
        submit waits until the worker drains below the bound (the
        serving loop absorbs the stall).  ``"shed"``: drop the OLDEST
        queued batch(es) to make room — their chunks simply stay
        unadmitted (a cache miss later, never a correctness issue) and
        are counted in ``stats.shed`` / ``stats.shed_fps``; in-flight
        batches cannot be shed, so the bound may momentarily overshoot
        by one unit.  ``"defer"``: reject the submit (``submit``
        returns ``False``, ``stats.deferred``) and let the caller retry
        after its decode, when the queue has usually drained.  None of
        the policies reorder accepted batches, so the coalescing
        bit-exactness argument and the drain-barrier semantics are
        untouched — the policies only choose WHICH batches enter the
        queue, not how they drain.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.serve.kv_index import KVIndexConfig
    >>> idx = MonarchKVIndex(KVIndexConfig(
    ...     n_sets=4, set_ways=16, admit_after_reads=0), device="cpu")
    >>> q = AdmitQueue(idx)
    >>> toks = np.arange(1, 33, dtype=np.int32).reshape(1, 32)
    >>> q.submit_tokens(toks)                 # returns immediately
    True
    >>> bool(q.lookup(toks).all())            # read-your-writes flush
    True
    >>> q.close()
    """

    POLICIES = ("block", "shed", "defer")

    def __init__(self, index: MonarchKVIndex, *, background: bool = True,
                 read_your_writes: bool = True, coalesce: bool = True,
                 max_pending: int | None = None, policy: str = "block"):
        if policy not in self.POLICIES:
            raise ValueError(f"AdmitQueue policy={policy!r}: expected one "
                             f"of {self.POLICIES}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"AdmitQueue max_pending={max_pending}: "
                             "expected a positive bound or None")
        self.index = index
        self.read_your_writes = read_your_writes
        self._coalesce = coalesce
        self.max_pending = max_pending
        self.policy = policy
        self.stats = AdmitQueueStats()
        self._background = background
        self._idx_lock = threading.Lock()    # serializes index access
        self._cv = threading.Condition()     # guards queue + pending set
        self._queue: collections.deque[np.ndarray] = collections.deque()
        self._pending: collections.Counter = collections.Counter()
        self._inflight = 0                   # batches popped, not yet admitted
        self._stop = False
        self._closed = False                 # close() called: no new work
        self._error: BaseException | None = None   # first worker failure
        self._worker = None
        if background:
            self._worker = threading.Thread(
                target=self._drain_loop, name="monarch-admit", daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "AdmitQueue is closed: submit()/lookup() after close() "
                "would feed a queue whose worker has exited (a later "
                "flush() could then block forever)")

    def _over_bound_locked(self, incoming: int) -> bool:
        """Would accepting ``incoming`` fps exceed ``max_pending``?
        (``_cv`` held.)  A fully drained queue always accepts — a single
        oversize batch must not wedge the submitter."""
        if self.max_pending is None:
            return False
        if not self._queue and self._inflight == 0:
            return False
        return sum(self._pending.values()) + incoming > self.max_pending

    def submit(self, fps: np.ndarray) -> bool:
        """Enqueue one admission batch (one future ``admit_fps`` call).

        ``fps`` must be unique within the batch, exactly as ``admit_fps``
        requires; returns immediately in background mode.  Returns
        ``True`` when the batch was accepted; ``False`` only under
        ``policy="defer"`` at the ``max_pending`` bound (the caller
        should retry after its decode).  Raises ``RuntimeError`` after
        :meth:`close`."""
        fps = np.asarray(fps, np.uint32)
        if fps.size == 0:
            return True
        with self._cv:
            self._check_open()
            if self.policy == "block":
                self._cv.wait_for(
                    lambda: self._closed
                    or not self._over_bound_locked(int(fps.size)))
                self._check_open()   # close() woke us: the worker is going
            elif self.policy == "shed":
                store = self.index.slab_store
                while self._over_bound_locked(int(fps.size)) and self._queue:
                    old = self._queue.popleft()
                    self._pending.subtract(int(f) for f in old)
                    self._pending += collections.Counter()  # drop zeros
                    if store is not None:
                        # the shed batch's admission will never run, so
                        # its staged KV slabs are garbage (a later
                        # re-offer recomputes and re-stages them).
                        for f in old:
                            store.discard(int(f))
                    self.stats.shed += 1
                    self.stats.shed_fps += int(old.size)
            elif self._over_bound_locked(int(fps.size)):    # defer
                self.stats.deferred += 1
                return False
            self.stats.submitted += int(fps.size)
            self._queue.append(fps)
            self._pending.update(int(f) for f in fps)
            self._cv.notify_all()
        if not self._background:
            self._drain_available()
        return True

    def submit_tokens(self, tokens: np.ndarray, slabs=None) -> bool:
        """Fingerprint a token batch and :meth:`submit` its unique chunks
        (the queue twin of ``MonarchKVIndex.admit``).

        Hashing goes through ``index.fingerprints`` so the scheme
        (``"block"`` vs ``"prefix"``) always matches lookup.  ``slabs``
        (optional ``{fp: kv-slab}``) are STAGED into the index's slab
        store before the batch enqueues, so by the time the async worker
        drains the batch every installing fingerprint finds its slab to
        commit — the submit-after-prefill ordering the resume path's
        read-your-writes guarantee builds on."""
        if slabs:
            store = self.index.slab_store
            if store is None:
                raise ValueError(
                    "submit_tokens(slabs=...) needs an index with an "
                    "attached KVSlabStore")
            for fp, slab in slabs.items():
                store.stage(int(fp), slab)
        fps = np.unique(self.index.fingerprints(tokens).reshape(-1))
        return self.submit(fps)

    def lookup(self, tokens: np.ndarray) -> np.ndarray:
        """Index lookup with optional read-your-writes consistency.

        When any looked-up fingerprint is still queued or in flight (and
        ``read_your_writes`` is on), the queue drains first so the search
        sees the submitted installs.  Raises ``RuntimeError`` after
        :meth:`close` — go to the index directly once the queue is gone."""
        with self._cv:
            self._check_open()
        if self.read_your_writes:
            fps = self.index.fingerprints(tokens).reshape(-1)
            with self._cv:
                waiting = bool(self._pending) and any(
                    int(fp) in self._pending for fp in fps)
            if waiting:
                self.stats.rww_flushes += 1
                self.flush()
        with self._idx_lock:
            return self.index.lookup(tokens)

    def flush(self) -> None:
        """Drain barrier: block until every submitted batch has been
        admitted (used before rotation and at shutdown).  Re-raises the
        first admission failure, if any (a failed batch is dropped, the
        worker keeps draining — the barrier never hangs on a dead
        worker)."""
        self.stats.flushes += 1
        if not self._background:
            self._drain_available()
        else:
            with self._cv:
                self._cv.wait_for(
                    lambda: not self._queue and self._inflight == 0)
        self._raise_pending_error()

    def _raise_pending_error(self) -> None:
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "admission batch failed in the AdmitQueue worker") from err

    def rotate(self) -> None:
        """Flush, then rotate the index — admissions never straddle the
        remap (the drain barrier the sharded lockstep roll requires)."""
        self.flush()
        with self._idx_lock:
            self.index._rotate()

    def pending(self) -> int:
        """Fingerprints submitted but not yet admitted."""
        with self._cv:
            return int(sum(self._pending.values()))

    def close(self, timeout: float = 30.0) -> None:
        """Flush and stop the worker.  Idempotent.

        After close, :meth:`submit` and :meth:`lookup` raise
        ``RuntimeError`` — enqueueing into a dead queue would otherwise
        silently strand the batch and wedge the next ``flush()``.  A
        worker that fails to stop within ``timeout`` seconds is a real
        hang (it holds the index lock) and is surfaced as a
        ``RuntimeError``, never swallowed."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()       # wake blocked submitters -> raise
        self.flush()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                raise RuntimeError(
                    f"AdmitQueue worker failed to stop within {timeout}s "
                    "(admission still in flight?)")
            self._worker = None

    def __enter__(self) -> "AdmitQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _pop_unit_locked(self) -> tuple[np.ndarray, int]:
        """Pop the next drain unit (``_cv`` held): the head batch plus any
        immediately following batches that stay mutually disjoint with it,
        concatenated in submission order (exactness argument in the module
        docstring), capped at ``COALESCE_MAX_FPS`` fingerprints.  Returns
        the unit and how many submitted batches it merges."""
        fps = self._queue.popleft()
        n_batches = 1
        if self._coalesce:
            seen = {int(f) for f in fps}
            parts = [fps]
            while (self._queue
                   and len(seen) + self._queue[0].size <= COALESCE_MAX_FPS):
                head = {int(f) for f in self._queue[0]}
                if seen & head:
                    break            # shared fp: touch counts need 2 calls
                parts.append(self._queue.popleft())
                seen |= head
                n_batches += 1
            if n_batches > 1:
                fps = np.concatenate(parts)
        self._inflight += 1
        return fps, n_batches

    def _admit_one_batch(self, fps: np.ndarray, n_batches: int = 1) -> None:
        err = None
        try:
            with self._idx_lock:
                self.index.admit_fps(fps)
            self.stats.batches += n_batches
            self.stats.coalesced += n_batches - 1
        except BaseException as e:           # noqa: BLE001 — must not kill
            err = e                          # the drain loop; surfaced at
        finally:                             # the next flush()
            with self._cv:
                self._pending.subtract(int(f) for f in fps)
                self._pending += collections.Counter()  # drop zeros
                self._inflight -= 1
                if err is not None and self._error is None:
                    self._error = err
                self._cv.notify_all()

    def _drain_available(self) -> None:
        """Synchronous drain (background=False path)."""
        while True:
            with self._cv:
                if not self._queue:
                    return
                fps, n_batches = self._pop_unit_locked()
            self._admit_one_batch(fps, n_batches)

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._queue or self._stop)
                if self._stop and not self._queue:
                    return
                fps, n_batches = self._pop_unit_locked()
            self._admit_one_batch(fps, n_batches)
