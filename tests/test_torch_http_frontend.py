"""The port's HTTP edge (``repro_torch/serve/http_frontend.py``,
``repro_torch/launch/httpd.py``) and the request loop under it, on the
CPU: the cases of tests/test_http_frontend.py at ``n_shards=1`` (the
port's index has one shard) and the request-loop cases of
tests/test_serve_frontend.py, plus the edge's decoded tokens against the
JAX reference over the same weights.

Most tests drive a loopback ``HttpFrontend`` over toy prefill/decode fns
(the router contract does not care); the end-to-end tests boot
``launch/httpd.py`` with a reduced model on the resume path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import doctest
import http.client
import json
import sys
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.launch import httpd
from repro_torch.launch import serve as t_serve
from repro_torch.launch.serve import RequestRecord, run_request_loop
from repro_torch.models import transformer as t_tf
from repro_torch.serve import http_frontend
from repro_torch.serve.admit_queue import AdmitQueue
from repro_torch.serve.http_frontend import (HttpFrontend, RouterClosed,
                                             ServeRouter)
from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                        MonarchKVIndex)
from test_torch_model import _top2_gap, assert_greedy_agree


def _mk_index(**kw) -> MonarchKVIndex:
    cfg = dict(n_sets=8, set_ways=16, admit_after_reads=0,
               rotate_every=1 << 30)
    cfg.update(kw)
    return MonarchKVIndex(KVIndexConfig(**cfg), device="cpu")


def _toks(i: int, chunks: int = 2, rows: int = 1) -> np.ndarray:
    base = 1 + i * 10_000
    n = rows * chunks * CHUNK_TOKENS
    return np.arange(base, base + n, dtype=np.int32).reshape(rows, -1)


@contextlib.contextmanager
def _frontend(*, prefill=None, decode="echo", admit_kw=None, **router_kw):
    """Loopback HttpFrontend over a toy router; always torn down."""
    q = AdmitQueue(_mk_index(), **(admit_kw or {}))
    router = ServeRouter(
        q, prefill_fn=prefill or (lambda t, h: None),
        decode_fn=(lambda t, s: t[:, -1:]) if decode == "echo" else decode,
        batch_window_s=router_kw.pop("batch_window_s", 0.0), **router_kw)
    fe = HttpFrontend(router).start()
    try:
        yield fe, q
    finally:
        with contextlib.suppress(Exception):
            fe.shutdown()
        with contextlib.suppress(RuntimeError):
            q.close()


def _req(fe: HttpFrontend, method: str, path: str, body=None,
         timeout: float = 30.0):
    host, port = fe.address
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    doc = json.loads(resp.read())
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, doc, headers


def _wait_for(pred, what: str, seconds: float = 30.0) -> None:
    """Poll ``pred`` until it holds; fail the test, naming ``what``, if it
    still does not after ``seconds`` (a loaded machine starts threads
    late, and a check made before the state it needs is a race)."""
    deadline = time.monotonic() + seconds
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail(f"waited {seconds} s for {what}")
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# endpoint round-trips


def test_module_doctest():
    """The module docstring's router round trip, on the CPU."""
    res = doctest.testmod(http_frontend)
    assert res.attempted >= 5 and res.failed == 0


def test_generate_healthz_stats_round_trip():
    with _frontend() as (fe, q):
        status, doc, _ = _req(fe, "GET", "/healthz")
        assert status == 200 and doc["status"] == "ok"

        toks = _toks(0)
        status, doc, _ = _req(fe, "POST", "/v1/generate",
                              {"tokens": toks.tolist()})
        assert status == 200
        assert doc["tokens"] == [[int(toks[0, -1])]]   # echo decode
        assert doc["chunks"] == 2 and doc["hit_chunks"] == 0
        assert doc["admitted"] and not doc["dropped"]
        assert doc["server_ms"] >= doc["service_ms"] >= 0

        # read-your-writes through the shared index
        status, doc, _ = _req(fe, "POST", "/v1/generate",
                              {"tokens": toks.tolist()})
        assert status == 200 and doc["hit_chunks"] == doc["chunks"] == 2

        q.flush()
        status, doc, _ = _req(fe, "GET", "/stats")
        assert status == 200
        assert doc["index"]["hit_rate"] == pytest.approx(0.5)
        assert doc["admit_queue"]["pending"] == 0
        assert "installs_per_set_max" in doc["wear"]
        assert doc["lifetime"]["years"] > 0
        assert doc["router"]["completed"] == 2
        assert doc["router"]["workers"] == 2


def test_bad_requests():
    with _frontend() as (fe, _):
        assert _req(fe, "GET", "/nope")[0] == 404
        assert _req(fe, "POST", "/nope")[0] == 404
        host, port = fe.address
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("POST", "/v1/generate", body=b"{not json")
        assert conn.getresponse().status == 400
        conn.close()
        assert _req(fe, "POST", "/v1/generate",
                    {"tokens": "strings"})[0] == 400
        assert _req(fe, "POST", "/v1/generate",
                    {"tokens": [[1, 2], [3]]})[0] == 400     # ragged
        assert _req(fe, "POST", "/v1/generate", {"tokens": []})[0] == 400
        assert _req(fe, "POST", "/v1/generate", {"wrong": 1})[0] == 400
        big = np.ones((1, (1 << 16) + CHUNK_TOKENS), np.int32)
        status, doc, _ = _req(fe, "POST", "/v1/generate",
                              {"tokens": big.tolist()})
        assert status == 400 and "cap" in doc["error"]


# ---------------------------------------------------------------------------
# back-pressure -> HTTP 429


def test_429_on_full_router_queue_with_retry_after():
    gate = threading.Event()
    held = threading.Event()

    def prefill(toks, hits):
        held.set()
        gate.wait(10)

    with _frontend(prefill=prefill, n_workers=1, max_queue=1) as (fe, q):
        done: list = []

        def client(i):
            done.append(_req(fe, "POST", "/v1/generate",
                             {"tokens": _toks(i).tolist()})[0])

        a = threading.Thread(target=client, args=(0,))
        a.start()                       # occupies the single worker
        _wait_for(held.is_set, "request 0 to reach the worker's prefill")
        _wait_for(lambda: fe.router.depth() == 1, "router depth 1")
        b = threading.Thread(target=client, args=(1,))
        b.start()                       # fills the queue (bound = 1)
        _wait_for(lambda: fe.router.depth() >= 2,
                  "request 1 queued behind it (router depth 2)")

        status, doc, headers = _req(fe, "POST", "/v1/generate",
                                    {"tokens": _toks(2).tolist()})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        assert doc["retry_after_s"] > 0
        gate.set()
        a.join(10)
        b.join(10)
        assert not a.is_alive() and not b.is_alive()
        assert done == [200, 200]       # accepted work never shed
        assert fe.router.stats.rejected_busy == 1


def test_router_submit_validation_and_busy():
    q = AdmitQueue(_mk_index())
    router = ServeRouter(q, prefill_fn=lambda t, h: None,
                         batch_window_s=0.0)
    with pytest.raises(ValueError, match="non-empty"):
        router.submit(np.arange(4, dtype=np.int32))        # 1-D
    with pytest.raises(ValueError, match="cap"):
        router.submit(np.ones((2, 1 << 16), np.int32))
    with pytest.raises(ValueError, match="n_workers"):
        ServeRouter(q, prefill_fn=lambda t, h: None, n_workers=0)
    router.begin_close()
    with pytest.raises(RouterClosed):
        router.submit(_toks(0))
    router.close()
    q.close()


def test_router_calls_idle_fn_while_no_request_comes():
    """An idle worker calls ``idle_fn`` every ``idle_s`` (a mesh's
    keep-alive), serves requests between the calls, and stops calling
    it once closed."""
    q = AdmitQueue(_mk_index(), background=False)
    idle = threading.Semaphore(0)
    router = ServeRouter(q, prefill_fn=lambda t, h: None,
                         decode_fn=lambda t, s: t[:, -1:], n_workers=1,
                         batch_window_s=0.0, idle_fn=idle.release,
                         idle_s=0.02)
    assert idle.acquire(timeout=10)
    assert router.submit(_toks(0))["tokens"] == [[int(_toks(0)[0, -1])]]
    assert idle.acquire(timeout=10)
    router.close()
    while idle.acquire(timeout=0.1):         # drain calls made before close
        pass
    assert not idle.acquire(timeout=0.1)
    q.close()


# ---------------------------------------------------------------------------
# micro-batcher


def test_micro_batcher_coalesces_same_shape_requests():
    gate = threading.Event()
    calls: list[tuple] = []

    def prefill(toks, hits):
        calls.append(toks.shape)
        if len(calls) == 1:
            gate.wait(10)               # hold the worker on request 0

    with _frontend(prefill=prefill, n_workers=1, max_queue=16,
                   batch_window_s=0.2, max_batch_rows=8) as (fe, q):
        results: dict[int, tuple] = {}

        def client(i, chunks):
            status, doc, _ = _req(fe, "POST", "/v1/generate",
                                  {"tokens": _toks(i, chunks).tolist()})
            results[i] = (status, doc)

        t0 = threading.Thread(target=client, args=(0, 2))
        t0.start()
        _wait_for(lambda: bool(calls), "request 0 in prefill")
        rest = [threading.Thread(target=client, args=(i, 2))
                for i in (1, 2, 3)]
        for t in rest:
            t.start()
        _wait_for(lambda: fe.router.depth() >= 4, "router depth 4")
        # a different-shape request lands BEHIND them (FIFO preserved)
        t4 = threading.Thread(target=client, args=(4, 3))
        t4.start()
        rest.append(t4)
        _wait_for(lambda: fe.router.depth() >= 5, "router depth 5")
        gate.set()
        for t in [t0] + rest:
            t.join(10)

        assert all(results[i][0] == 200 for i in range(5))
        assert [results[i][1]["batched_rows"] for i in (1, 2, 3, 4)] == \
            [3, 3, 3, 1]
        assert (3, 2 * CHUNK_TOKENS) in calls
        assert fe.router.stats.coalesced == 2
        for i in (1, 2, 3):
            assert results[i][1]["chunks"] == 2
            assert results[i][1]["tokens"] == [[int(_toks(i)[0, -1])]]


# ---------------------------------------------------------------------------
# concurrent clients over ONE shared index


def test_concurrent_clients_read_your_writes():
    with _frontend(n_workers=4, max_queue=64) as (fe, q):
        failures: list = []

        def client(i):
            toks = _toks(i, chunks=3).tolist()
            s1, d1, _ = _req(fe, "POST", "/v1/generate", {"tokens": toks})
            s2, d2, _ = _req(fe, "POST", "/v1/generate", {"tokens": toks})
            if s1 != 200 or s2 != 200:
                failures.append((i, s1, s2))
            elif d2["hit_chunks"] != d2["chunks"]:
                failures.append((i, "second trip missed", d2))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures
        assert fe.router.stats.completed == 16


def test_bounded_equals_unbounded_index_state():
    """The admission bound only paces admissions: sequentially the
    bounded-queue index equals the unbounded one exactly; under
    concurrent clients the resident set and admission totals match."""
    def drive_sequential(admit_kw):
        with _frontend(admit_kw=admit_kw) as (fe, q):
            for i in range(6):
                s, _, _ = _req(fe, "POST", "/v1/generate",
                               {"tokens": _toks(i, chunks=3).tolist()})
                assert s == 200
            q.flush()
            idx = q.index
            return (dict(idx.slot_of), idx.valid.numpy().copy(),
                    idx.fp_of.numpy().copy(), idx.stats.admissions)

    bounded = drive_sequential({"max_pending": 4, "policy": "block"})
    unbounded = drive_sequential({})
    assert bounded[0] == unbounded[0]
    np.testing.assert_array_equal(bounded[1], unbounded[1])
    np.testing.assert_array_equal(bounded[2], unbounded[2])
    assert bounded[3] == unbounded[3]

    def drive_concurrent(admit_kw):
        with _frontend(n_workers=4, max_queue=64,
                       admit_kw=admit_kw) as (fe, q):
            threads = [threading.Thread(
                target=lambda i=i: _req(fe, "POST", "/v1/generate",
                                        {"tokens": _toks(i, 3).tolist()}))
                for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            q.flush()
            return (frozenset(int(f) for f in q.index.slot_of),
                    q.index.stats.admissions)

    assert drive_concurrent({"max_pending": 4, "policy": "block"}) == \
        drive_concurrent({})


# ---------------------------------------------------------------------------
# graceful shutdown


def test_graceful_shutdown_drains_without_losing_admissions():
    gate = threading.Event()

    def prefill(toks, hits):
        gate.wait(10)

    with _frontend(prefill=prefill, n_workers=1, max_queue=8) as (fe, q):
        done: list = []

        def client(i):
            done.append(_req(fe, "POST", "/v1/generate",
                             {"tokens": _toks(i).tolist()})[0])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        _wait_for(lambda: fe.router.depth() >= 3, "router depth 3")

        fe.begin_shutdown()             # the SIGTERM half
        status, _, _ = _req(fe, "POST", "/v1/generate",
                            {"tokens": _toks(9).tolist()})
        assert status == 503
        h_status, h_doc, _ = _req(fe, "GET", "/healthz")
        assert h_status == 503 and h_doc["status"] == "draining"

        gate.set()
        fe.shutdown()                   # drains router + admit queue
        for t in threads:
            t.join(10)
        assert done == [200, 200, 200]
        assert q.index.stats.admissions == 3 * 2
        assert fe.router.stats.rejected_closed == 1


# ---------------------------------------------------------------------------
# shared counters under concurrent workers


def test_launch_counts_and_engine_counts_under_threads():
    """Several router workers search, admit and prefill at once: no count
    may lose an update (12 threads, a short switch interval)."""
    from repro_torch.serve.kv_index import KVSlabStore
    from repro_torch.serve.resume import PrefixResumeEngine
    cfg = dataclasses.replace(t_configs.get_arch("gemma3-27b").reduced(),
                              n_layers=1, vocab_size=64)
    idx = MonarchKVIndex(KVIndexConfig(n_sets=8, fingerprint="prefix",
                                       admit_after_reads=0),
                         slab_store=KVSlabStore(), device="cpu")
    eng = PrefixResumeEngine(t_tf.init_params(cfg, device="cpu"), cfg,
                             max_seq=40, index=idx, device="cpu")
    n_threads, reps = 12, 6
    before = (t_ops.LAUNCH_COUNT, t_ops.ADMIT_LAUNCH_COUNT)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for r in range(reps):
                toks = _toks(i * reps + r, chunks=2)
                idx.lookup(toks)
                idx.admit(toks)
                eng.prefill(toks % 64, None)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    n = n_threads * reps
    assert t_ops.LAUNCH_COUNT - before[0] == n
    assert t_ops.ADMIT_LAUNCH_COUNT - before[1] == n
    assert eng.computed_chunks == 2 * n and eng.resumed_chunks == 0


# ---------------------------------------------------------------------------
# the shared request loop (tests/test_serve_frontend.py)


class FakeClock:
    """Injectable ``now_fn``: seconds, advanced explicitly."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def test_request_loop_open_loop_latency_counts_backlog():
    clk = FakeClock()
    q = AdmitQueue(_mk_index(n_sets=4), background=False)
    service_s = 0.1

    def prefill(toks, hits):
        clk.advance(service_s)

    reqs = [np.arange(1 + 64 * i, 1 + 64 * i + 2 * CHUNK_TOKENS,
                      dtype=np.int32).reshape(1, -1) for i in range(3)]
    recs = run_request_loop(
        q, reqs, prefill_fn=prefill, arrivals_s=[0.0, 0.0, 0.5],
        now_fn=clk, sleep_fn=clk.advance)
    q.close()
    lat = [r.latency_s for r in recs]
    assert lat[0] == pytest.approx(service_s)
    assert lat[1] == pytest.approx(2 * service_s)   # waited behind 0
    assert lat[2] == pytest.approx(service_s)       # idle arrival
    assert recs[2].arrival_s == pytest.approx(0.5)
    assert all(r.admitted and not r.retried and not r.dropped for r in recs)
    assert all(isinstance(r, RequestRecord) for r in recs)


class _ScriptedQueue:
    """AdmitQueue stand-in with scripted submit outcomes."""

    def __init__(self, outcomes):
        self._outcomes = list(outcomes)

    def lookup(self, tokens):
        return np.zeros((tokens.shape[0],
                         tokens.shape[1] // CHUNK_TOKENS), bool)

    def submit_tokens(self, tokens):
        return self._outcomes.pop(0)


def test_request_loop_defer_retry_and_drop():
    toks = np.arange(1, 1 + 2 * CHUNK_TOKENS, dtype=np.int32).reshape(1, -1)
    recs = run_request_loop(_ScriptedQueue([False, True]), [toks],
                            prefill_fn=lambda t, h: None)
    assert recs[0].retried and recs[0].admitted and not recs[0].dropped
    recs = run_request_loop(_ScriptedQueue([False, False]), [toks],
                            prefill_fn=lambda t, h: None)
    assert recs[0].retried and recs[0].dropped and not recs[0].admitted


class _DrainingQueue(_ScriptedQueue):
    """Defer-rejecting queue whose backlog drains at a known time."""

    def __init__(self, clk: FakeClock, drain_at: float):
        super().__init__([])
        self._clk, self._drain_at = clk, drain_at

    def pending(self) -> int:
        return 0 if self._clk.t >= self._drain_at else 3

    def submit_tokens(self, tokens):
        return self.pending() == 0


def test_request_loop_defer_retry_waits_for_drain():
    toks = np.arange(1, 1 + 2 * CHUNK_TOKENS, dtype=np.int32).reshape(1, -1)
    clk = FakeClock()
    recs = run_request_loop(_DrainingQueue(clk, drain_at=0.02), [toks],
                            prefill_fn=lambda t, h: None, now_fn=clk,
                            sleep_fn=clk.advance, retry_wait_s=0.1)
    assert recs[0].retried and recs[0].admitted and not recs[0].dropped
    assert clk.t < 0.1 + 1e-9          # stopped as soon as it drained

    clk = FakeClock()
    recs = run_request_loop(_DrainingQueue(clk, drain_at=0.02), [toks],
                            prefill_fn=lambda t, h: None, now_fn=clk,
                            sleep_fn=clk.advance, retry_wait_s=0.0)
    assert recs[0].retried and recs[0].dropped and not recs[0].admitted


def test_serve_main_tiny_prompt_reports_na(capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        records = t_serve.main(
            ["--arch", "yi-9b", "--reduced", "--device", "cpu",
             "--requests", "1", "--batch", "1", "--prompt-len", "16",
             "--decode-tokens", "2"])
    out = capsys.readouterr().out
    assert "prefix chunks cached n/a" in out
    assert "nan" not in out.lower()
    assert records[0].decoded.shape == (1, 2)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-27b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_serve_main_non_resume_decode_returns_tokens(arch, capsys):
    records = t_serve.main(
        ["--arch", arch, "--reduced", "--device", "cpu", "--no-resume",
         "--requests", "2", "--batch", "1", "--prompt-len", "32",
         "--decode-tokens", "3"])
    assert len(records) == 2
    for rec in records:
        assert rec.decoded.shape == (1, 3)
        assert rec.decoded.dtype.kind in "iu"
        assert rec.resumed_chunks == 0
    if arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        # recurrent layers: resume is off without --no-resume too, and
        # the launcher says so
        records = t_serve.main(
            ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
             "2", "--batch", "1", "--prompt-len", "32", "--decode-tokens",
             "2"])
        assert [r.resumed_chunks for r in records] == [0, 0]
        assert "resume path off" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the full stack: launch/httpd.py end to end (reduced model, resume)


def _httpd_args(arch: str, *extra):
    return httpd.build_parser().parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--port", "0",
         "--prompt-len", "48", "--decode-tokens", "3",
         "--batch-window-ms", "0", "--n-workers", "2",
         "--admit-after-reads", "0", *extra])


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-27b"])
def test_httpd_end_to_end_prefix_hit_resumes_decode(arch):
    fe, q = httpd.build_frontend(_httpd_args(arch))
    fe.start()
    try:
        toks = np.arange(1, 49, dtype=np.int32).reshape(1, 48) % 500 + 1
        status, first, _ = _req(fe, "POST", "/v1/generate",
                                {"tokens": toks.tolist()}, timeout=120)
        assert status == 200
        assert np.asarray(first["tokens"]).shape == (1, 3)
        assert first["chunks"] == 3 and first["hit_chunks"] == 0

        status, second, _ = _req(fe, "POST", "/v1/generate",
                                 {"tokens": toks.tolist()}, timeout=120)
        assert status == 200
        assert second["hit_chunks"] == 3          # fully cached prompt
        assert second["resumed_chunks"] == 2      # capped at (S-1)//16
        assert second["tokens"] == first["tokens"]

        fe.begin_shutdown()
        assert _req(fe, "POST", "/v1/generate",
                    {"tokens": toks.tolist()})[0] == 503
    finally:
        fe.shutdown()
        q.close()


def test_httpd_recurrent_model_serves_without_resume(capsys):
    """Reduced zamba2 (Mamba-2 layers and the shared attention block)
    behind the edge: resume off, a "block" index, no slab store; a
    repeated prompt hits every chunk, resumes none and decodes the same
    tokens."""
    fe, q = httpd.build_frontend(_httpd_args("zamba2-2.7b"))
    fe.start()
    try:
        assert q.index.cfg.fingerprint == "block"
        assert q.index.slab_store is None
        toks = np.arange(1, 49, dtype=np.int32).reshape(1, 48) % 500 + 1
        docs = []
        for _ in range(2):
            status, doc, _ = _req(fe, "POST", "/v1/generate",
                                  {"tokens": toks.tolist()}, timeout=120)
            assert status == 200
            docs.append(doc)
        assert np.asarray(docs[0]["tokens"]).shape == (1, 3)
        assert (docs[0]["hit_chunks"], docs[1]["hit_chunks"]) == (0, 3)
        assert docs[0]["resumed_chunks"] == docs[1]["resumed_chunks"] == 0
        assert docs[1]["tokens"] == docs[0]["tokens"]
        assert _req(fe, "GET", "/healthz")[0] == 200
    finally:
        fe.shutdown()
        q.close()
    assert "resume off" in capsys.readouterr().out


def test_httpd_tokens_match_reference():
    """Reduced gemma3 (4 local layers, window 32) with the reference's
    weights: two 48-token prompts sharing 32 tokens go through the edge
    (the second resumes 2 chunks from slabs, its ring wrapped); the
    answers equal the JAX reference's full prefill + greedy decode under
    the margin rule."""
    n_dec = 3
    jcfg = j_configs.get_arch("gemma3-27b").reduced()
    jp = j_tf.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = t_configs.get_arch("gemma3-27b").reduced()
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    rng = np.random.default_rng(4)
    shared = rng.integers(1, jcfg.vocab_size, (1, 32))
    prompts = [np.concatenate([shared, rng.integers(1, jcfg.vocab_size,
                                                    (1, 16))], axis=1)
               .astype(np.int32) for _ in range(2)]
    fe, q = httpd.build_frontend(_httpd_args("gemma3-27b"), params=tp)
    fe.start()
    try:
        answers = []
        for toks in prompts:
            status, doc, _ = _req(fe, "POST", "/v1/generate",
                                  {"tokens": toks.tolist()}, timeout=120)
            assert status == 200
            answers.append(doc)
    finally:
        fe.shutdown()
        q.close()
    assert answers[1]["resumed_chunks"] == 2
    for toks, doc in zip(prompts, answers):
        logits, cache = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                     48 + n_dec)
        want, gaps = [], []
        for t in range(n_dec):
            lg = np.asarray(logits)
            want.append(lg.argmax(-1))
            gaps.append(_top2_gap(lg))
            nxt = jnp.asarray(want[-1].astype(np.int32)[:, None])
            logits, cache = j_tf.decode_step(jp, jcfg, nxt, cache,
                                             jnp.int32(48 + t))
        assert_greedy_agree(np.asarray(doc["tokens"]), np.stack(want, 1),
                            np.stack(gaps, 1))


def test_httpd_refuses_shards_and_defaults_to_the_card():
    """``--n-shards 2`` now builds (its two set shards co-locate on the
    one device); without ``--device`` the edge still wants the card."""
    fe, q = httpd.build_frontend(_httpd_args("yi-9b", "--n-shards", "2"))
    fe.start()
    try:
        assert q.index.n_shards == 2 and q.index.n_parts == 1
        assert q.index.sets_per_shard == 4
    finally:
        fe.shutdown()
        q.close()
    args = httpd.build_parser().parse_args(["--reduced"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            httpd.build_frontend(args)
