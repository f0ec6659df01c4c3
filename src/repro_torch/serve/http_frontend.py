"""HTTP network edge over the Monarch serving stack (port of
``repro/serve/http_frontend.py``; stdlib and numpy over the port's
``AdmitQueue`` and ``run_request_loop``).

A stdlib-only HTTP server (``http.server.ThreadingHTTPServer``) exposes
the serving loop to the network, backed by a multi-worker router that
drives ``run_request_loop`` against ONE shared ``MonarchKVIndex`` /
``AdmitQueue`` / ``KVSlabStore``.

Endpoints:

* ``POST /v1/generate`` — body ``{"tokens": [[...], ...]}`` (a (B, S)
  int batch); answers the decoded tokens plus the request's prefix
  accounting (``chunks`` / ``hit_chunks`` / ``resumed_chunks``,
  admission outcome, queue + service time).
* ``GET /healthz`` — liveness; 200 while accepting, 503 once draining.
* ``GET /stats`` — JSON snapshot: ``idx.stats``, ``admit_q.stats``,
  ``wear_report()``, ``lifetime_estimate()``, router counters.

Layering:

* :class:`ServeRouter` — N worker threads pull requests off one bounded
  queue.  Each worker runs the SHARED request loop
  (:func:`repro_torch.launch.serve.run_request_loop`: lookup -> prefill/
  resume -> submit -> decode) on its micro-batch, so every semantic the
  loop pins (read-your-writes lookups, submit-after-prefill slab
  staging, defer-retry with bounded drain-wait) holds on the network
  path.  A **micro-batcher** coalesces same-shape requests that arrive
  within ``batch_window_s`` into one prefill batch — one fused XAM
  lookup and one prefill instead of B.
* Back-pressure maps to HTTP semantics: a submit that would overflow
  the router's bounded queue raises :class:`RouterBusy`, which the
  handler answers as **429 with a Retry-After** drain estimate (reject
  NEW work, never abandon accepted work).  After shutdown begins, new
  requests get **503** while accepted ones drain.
* :class:`HttpFrontend` — socket lifecycle.  ``shutdown()`` is
  graceful: stop admitting (503), drain the router queue and in-flight
  batches, flush the admission queue, then stop the listener — no
  accepted request or submitted admission is lost.

Thread safety.  The router's queue and counters live under one
condition variable.  The workers call the model at the same time, and
the port's model functions are not pure as the reference's were, so
what they share was audited; no lock around the model is needed:

* index access (lookups, admissions, rotation) is serialized by the
  ``AdmitQueue``'s index lock, and the ``KVSlabStore`` has its own;
* every request gets its own decode cache and slabs from
  ``transformer.prefill``, so the in-place cache writes of
  ``decode_step`` never touch another request's cache; the parameters
  are only read;
* the shared counters are written under locks:
  ``PrefixResumeEngine``'s chunk counters and the XAM launch counts
  (``kernels/xam_search/ops.count_launch``);
* the kernel libraries load once behind ``functools.lru_cache`` (two
  first calls at once would build the same file twice and rename it
  into place atomically).

On a card every worker issues its kernels to the device's default
stream, which orders them; torch releases the GIL inside each op.

Examples
--------
The router round-trip, HTTP layer aside (the handler calls exactly
this):

>>> import numpy as np
>>> from repro_torch.serve.kv_index import KVIndexConfig, MonarchKVIndex
>>> from repro_torch.serve.admit_queue import AdmitQueue
>>> from repro_torch.serve.http_frontend import ServeRouter
>>> q = AdmitQueue(MonarchKVIndex(KVIndexConfig(
...     n_sets=4, set_ways=16, admit_after_reads=0), device="cpu"))
>>> router = ServeRouter(q, prefill_fn=lambda toks, hits: None,
...                      decode_fn=lambda toks, state: toks[:, -1:])
>>> toks = np.arange(1, 33, dtype=np.int32).reshape(1, 32)
>>> out = router.submit(toks)            # lookup -> prefill -> decode
>>> out["tokens"], out["chunks"], out["hit_chunks"]
([[32]], 2, 0)
>>> router.submit(toks)["hit_chunks"]    # read-your-writes: now cached
2
>>> router.close(); q.close()
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.serve.admit_queue import AdmitQueue

#: Hard cap on tokens per request batch (rows x cols): a request larger
#: than this answers 400 instead of occupying a worker for seconds.
MAX_REQUEST_TOKENS = 1 << 16


class RouterBusy(RuntimeError):
    """Bounded router queue is full — the HTTP layer answers 429.

    ``retry_after_s`` is the drain estimate (queue depth x EWMA batch
    service time / workers) the handler rounds up into ``Retry-After``.
    """

    def __init__(self, retry_after_s: float):
        super().__init__(f"router queue full; retry after "
                         f"~{retry_after_s:.3f}s")
        self.retry_after_s = float(retry_after_s)


class RouterClosed(RuntimeError):
    """Shutdown has begun — the HTTP layer answers 503."""


@dataclasses.dataclass
class RouterStats:
    received: int = 0         # requests accepted into the queue
    completed: int = 0        # requests answered successfully
    errors: int = 0           # requests failed inside a worker
    rejected_busy: int = 0    # 429s: bounded queue full
    rejected_closed: int = 0  # 503s: submit after shutdown began
    batches: int = 0          # micro-batches served
    coalesced: int = 0        # requests merged beyond a batch head


@dataclasses.dataclass
class _Pending:
    """One enqueued request: tokens in, result/error + event out."""
    tokens: np.ndarray
    t_enqueue: float
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: dict | None = None
    error: BaseException | None = None


class ServeRouter:
    """Multi-worker request router over one shared serving front end.

    Parameters
    ----------
    admit_q : AdmitQueue
        THE shared front end — every worker's lookups and admissions go
        through it, so cross-request read-your-writes and the bounded
        admission semantics hold across all workers.
    prefill_fn, decode_fn : callables
        Exactly ``run_request_loop``'s contract (the launcher's model
        fns or the resume engine's pair).
        ``decode_fn``'s return value is the decoded ``(B, T)`` token
        array answered to the client (``None`` -> no tokens field).
    n_workers : int
        Serving worker threads.  Each runs the shared request loop on
        its own micro-batches; index state stays consistent because all
        index access is serialized by the AdmitQueue locks.
    max_queue : int
        Bound on requests queued (in-flight ones excluded).  At the
        bound :meth:`submit` raises :class:`RouterBusy` — mapped to 429
        by the HTTP layer.
    batch_window_s : float
        Micro-batch window: after popping a request, a worker waits up
        to this long for more SAME-SHAPE requests and serves them as
        one prefill batch.  ``0`` disables coalescing.
    max_batch_rows : int
        Row cap per coalesced batch.
    retry_wait_s : float
        Passed through to ``run_request_loop`` (bounded drain-wait
        before the one defer retry).
    now_fn : callable
        Clock injection for tests.
    idle_fn, idle_s : callable, float
        A worker that has waited ``idle_s`` seconds without a request
        calls ``idle_fn()`` (outside the lock), and again after each
        further ``idle_s``: a mesh's process 0 keeps the other
        processes' waits alive with it.  ``None`` never calls it.
    """

    def __init__(self, admit_q: AdmitQueue, *, prefill_fn, decode_fn=None,
                 n_workers: int = 2, max_queue: int = 64,
                 batch_window_s: float = 0.002, max_batch_rows: int = 8,
                 retry_wait_s: float = 0.05, now_fn=time.monotonic,
                 idle_fn=None, idle_s: float | None = None):
        if n_workers < 1:
            raise ValueError(f"ServeRouter n_workers={n_workers}: expected "
                             ">= 1")
        if max_queue < 1:
            raise ValueError(f"ServeRouter max_queue={max_queue}: expected "
                             ">= 1")
        self.admit_q = admit_q
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.n_workers = n_workers
        self.max_queue = max_queue
        self.batch_window_s = float(batch_window_s)
        self.max_batch_rows = max_batch_rows
        self.retry_wait_s = retry_wait_s
        self._now = now_fn
        self.idle_fn = idle_fn
        self.idle_s = None if idle_fn is None else idle_s
        self.stats = RouterStats()
        self._cv = threading.Condition()
        self._queue: collections.deque[_Pending] = collections.deque()
        self._inflight = 0                  # batches popped, not answered
        self._closing = False               # no new submits (503)
        self._stop = False                  # workers may exit once drained
        self._service_ewma_s = 1e-3         # per-batch service estimate
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"monarch-http-{i}", daemon=True)
            for i in range(n_workers)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------
    def _retry_after_s_locked(self) -> float:
        """Drain estimate for Retry-After (``_cv`` held)."""
        depth = len(self._queue) + self._inflight
        return max(depth * self._service_ewma_s / self.n_workers, 1e-3)

    def submit(self, tokens: np.ndarray, timeout: float = 60.0) -> dict:
        """Serve one request batch through the worker pool.

        Blocks the CALLING thread (one HTTP connection thread per
        request) until its micro-batch has been served; workers and
        other clients are never blocked by it.  Raises
        :class:`RouterBusy` at the queue bound, :class:`RouterClosed`
        once shutdown began, and re-raises a worker-side failure."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2 or tokens.size == 0:
            raise ValueError(f"tokens: expected a non-empty (B, S) int "
                             f"batch, got shape {tokens.shape}")
        if tokens.size > MAX_REQUEST_TOKENS:
            raise ValueError(f"tokens: {tokens.size} tokens exceeds the "
                             f"per-request cap {MAX_REQUEST_TOKENS}")
        p = _Pending(tokens=tokens, t_enqueue=self._now())
        with self._cv:
            if self._closing:
                self.stats.rejected_closed += 1
                raise RouterClosed("router is draining (shutdown begun)")
            if len(self._queue) >= self.max_queue:
                self.stats.rejected_busy += 1
                raise RouterBusy(self._retry_after_s_locked())
            self.stats.received += 1
            self._queue.append(p)
            self._cv.notify_all()
        if not p.event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if p.error is not None:
            raise RuntimeError("request failed in a router worker") \
                from p.error
        return p.result

    def depth(self) -> int:
        """Requests queued or in flight right now."""
        with self._cv:
            return len(self._queue) + self._inflight

    def begin_close(self) -> None:
        """Stop accepting (new submits raise :class:`RouterClosed`);
        queued and in-flight requests keep draining."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()

    def close(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: refuse new work, drain everything accepted
        (requests AND their submitted admissions), stop the workers.
        Idempotent.  The caller still owns ``admit_q.close()``."""
        self.begin_close()
        with self._cv:
            if not self._cv.wait_for(
                    lambda: not self._queue and self._inflight == 0,
                    timeout=timeout):
                raise RuntimeError(
                    f"ServeRouter failed to drain within {timeout}s "
                    f"({len(self._queue)} queued, {self._inflight} in "
                    "flight)")
            self._stop = True
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=timeout)
            if w.is_alive():
                raise RuntimeError("ServeRouter worker failed to stop")
        self._workers = []
        self.admit_q.flush()         # every submitted admission lands

    def __enter__(self) -> "ServeRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _next_batch(self) -> list[_Pending] | None:
        """Pop the next micro-batch (None = stopped and drained; an empty
        list = ``idle_s`` passed without one): the head request plus any
        same-shape requests arriving within ``batch_window_s``, capped at
        ``max_batch_rows`` rows."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._queue or self._stop,
                                     timeout=self.idle_s):
                return []

            if not self._queue:
                return None              # stopping and fully drained
            head = self._queue.popleft()
            self._inflight += 1
            batch = [head]
            rows = head.tokens.shape[0]
            deadline = self._now() + self.batch_window_s
            while self.batch_window_s > 0 and rows < self.max_batch_rows:
                if self._queue:
                    nxt = self._queue[0]
                    if (nxt.tokens.shape[1:] != head.tokens.shape[1:]
                            or rows + nxt.tokens.shape[0]
                            > self.max_batch_rows):
                        break            # shape mismatch / row cap
                    batch.append(self._queue.popleft())
                    rows += nxt.tokens.shape[0]
                    continue
                remaining = deadline - self._now()
                if remaining <= 0 or self._stop:
                    break
                self._cv.wait(timeout=remaining)
            return batch

    def _serve_batch(self, batch: list[_Pending]) -> None:
        # Local import: launch.serve imports serve.* at module load —
        # importing it lazily here keeps the package acyclic.
        from repro_torch.launch.serve import run_request_loop
        toks = (batch[0].tokens if len(batch) == 1 else
                np.concatenate([p.tokens for p in batch], axis=0))
        t_start = self._now()
        cap: dict = {}

        def on_batch(i, t, hits, rec):
            cap["hits"] = np.asarray(hits, bool)

        err = None
        try:
            rec = run_request_loop(
                self.admit_q, [toks], prefill_fn=self.prefill_fn,
                decode_fn=self.decode_fn, retry_wait_s=self.retry_wait_s,
                on_batch=on_batch)[0]
            t_done = self._now()
            hits = cap["hits"]
            n_rows = toks.shape[0]
            decoded = (None if rec.decoded is None
                       else np.asarray(rec.decoded))
            # resumed_chunks is the batch's resume run x rows — the run
            # is common to every row, so it splits evenly.
            per_row_resumed = rec.resumed_chunks // max(n_rows, 1)
            row = 0
            for p in batch:
                b = p.tokens.shape[0]
                h = hits[row:row + b]
                p.result = {
                    "tokens": (None if decoded is None
                               else decoded[row:row + b].tolist()),
                    "n_rows": b,
                    "chunks": int(h.size),
                    "hit_chunks": int(h.sum()),
                    "resumed_chunks": per_row_resumed * b,
                    "admitted": bool(rec.admitted),
                    "dropped": bool(rec.dropped),
                    "batched_rows": n_rows,
                    "queued_ms": round((t_start - p.t_enqueue) * 1e3, 3),
                    "service_ms": round((t_done - t_start) * 1e3, 3),
                }
                row += b
        except BaseException as e:       # noqa: BLE001 — a worker must
            err = e                      # survive any request failure
            for p in batch:
                p.error = e
        finally:
            with self._cv:
                self._inflight -= 1
                self.stats.batches += 1
                self.stats.coalesced += len(batch) - 1
                if err is None:
                    self.stats.completed += len(batch)
                    dt = max(self._now() - t_start, 1e-6)
                    self._service_ewma_s = (0.8 * self._service_ewma_s
                                            + 0.2 * dt)
                else:
                    self.stats.errors += len(batch)
                self._cv.notify_all()
            for p in batch:
                p.event.set()

    def _worker_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            if batch:
                self._serve_batch(batch)
            else:
                self.idle_fn()


# ---------------------------------------------------------------------------
# the socket layer


def stats_snapshot(router: ServeRouter) -> dict:
    """The ``GET /stats`` document: index / admission / wear / lifetime
    / router counters, all JSON-ready.

    Index reads are serialized against the admission worker: the wear /
    lifetime views read planes that an in-flight admission updates in
    place."""
    q = router.admit_q
    idx = q.index
    idx_lock = getattr(q, "_idx_lock", None) or contextlib.nullcontext()
    with idx_lock:
        lt = idx.lifetime_estimate()
        wear = idx.wear_report()
        istats = dataclasses.asdict(idx.stats)
        hit_rate = round(float(idx.hit_rate), 6)
    with router._cv:
        depth = len(router._queue) + router._inflight
        rstats = dataclasses.asdict(router.stats)
    return {
        "index": istats | {"hit_rate": hit_rate},
        "admit_queue": dataclasses.asdict(q.stats)
        | {"pending": q.pending()},
        "wear": wear,
        "lifetime": dataclasses.asdict(lt),
        "router": rstats | {"depth": depth, "workers": router.n_workers},
    }


class _Handler(BaseHTTPRequestHandler):
    """Request handler over ``self.server.router`` (a ServeRouter)."""

    server_version = "MonarchServe/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # noqa: A003 — stdlib signature
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # -- helpers -------------------------------------------------------
    def _send_json(self, status: int, doc: dict,
                   headers: dict | None = None) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # -- endpoints -----------------------------------------------------
    def do_GET(self):                    # noqa: N802 — stdlib hook name
        router: ServeRouter = self.server.router
        if self.path == "/healthz":
            with router._cv:
                closing = router._closing
                depth = len(router._queue) + router._inflight
            if closing:
                self._send_json(503, {"status": "draining",
                                      "depth": depth})
            else:
                self._send_json(200, {"status": "ok", "depth": depth,
                                      "workers": router.n_workers})
        elif self.path == "/stats":
            try:
                self._send_json(200, stats_snapshot(router))
            except RuntimeError as e:    # keep the connection answered
                self._send_json(500, {"error": str(e)})
        else:
            self._send_json(404, {"error": f"unknown path {self.path}; "
                                  "endpoints: POST /v1/generate, "
                                  "GET /healthz, GET /stats"})

    def do_POST(self):                   # noqa: N802 — stdlib hook name
        if self.path != "/v1/generate":
            self._send_json(404, {"error": f"unknown path {self.path}; "
                                  "POST goes to /v1/generate"})
            return
        t0 = time.monotonic()
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length))
            tokens = np.asarray(doc["tokens"], dtype=np.int32)
        except (ValueError, TypeError, KeyError, json.JSONDecodeError):
            self._send_json(400, {"error": "body must be JSON "
                                  '{"tokens": [[...int...], ...]} — a '
                                  "rectangular (B, S) int batch"})
            return
        router: ServeRouter = self.server.router
        try:
            result = router.submit(tokens)
        except ValueError as e:          # shape / size validation
            self._send_json(400, {"error": str(e)})
            return
        except RouterBusy as e:          # back-pressure -> 429
            retry_s = max(math.ceil(e.retry_after_s), 1)
            self._send_json(
                429, {"error": "server overloaded (router queue full)",
                      "retry_after_s": round(e.retry_after_s, 3)},
                headers={"Retry-After": str(retry_s)})
            return
        except RouterClosed:             # draining -> 503
            self._send_json(503, {"error": "server shutting down"})
            return
        except (RuntimeError, TimeoutError) as e:   # worker-side failure
            self._send_json(500, {"error": str(e)})
            return
        result = dict(result)
        result["server_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        self._send_json(200, result)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default accept backlog (5) drops connections under
    # bursty open-loop arrivals; router admission is the real limiter
    request_queue_size = 128


class HttpFrontend:
    """Socket lifecycle around a :class:`ServeRouter`.

    ``start()`` serves on a daemon thread; :meth:`shutdown` performs the
    graceful sequence: 503 new requests -> drain router + admissions ->
    stop the listener.  ``port=0`` binds an ephemeral port (read it back
    from :attr:`address`)."""

    def __init__(self, router: ServeRouter, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False):
        self.router = router
        self.server = _Server((host, port), _Handler)
        self.server.router = router
        self.server.verbose = verbose
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        """(host, port) actually bound."""
        return self.server.server_address[:2]

    def start(self) -> "HttpFrontend":
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="monarch-httpd",
            daemon=True)
        self._thread.start()
        return self

    def begin_shutdown(self) -> None:
        """SIGTERM half: new requests answer 503 from this point on."""
        self.router.begin_close()

    def shutdown(self) -> None:
        """Graceful stop: drain accepted requests and the admission
        queue, then close the listener.  Idempotent."""
        self.begin_shutdown()
        self.router.close()
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "HttpFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
