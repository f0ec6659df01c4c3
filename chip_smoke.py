#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises (exit
code 1) on failure:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the four Hopper kernel libraries from ``src/`` (nvcc,
   into ``build/repro_torch/``, all started together), with each build's
   seconds and ptxas registers.
2. Kernel against its plain version on the card: the fused multi-set XAM
   search (CUDA) against ``xam_search_multiset_plain`` over int8 and
   packed8 planes, both scorings, dead blocks, zero-mask rows and empty
   sets, and the edge matrix of its redesign (``multiset_edge_cases``:
   R up to 512, C up to 5000, first matches at the column vectors' edges)
   — exact equality — then timed with CUDA events (L2 flushed before
   every rep, median of the reps) at four shapes.
3. Serve: ``repro_torch.launch.serve`` at yi-9b full width and depth
   (d_model 4096, 32/4 heads, d_ff 11008, vocab 64000, 48 layers, bf16,
   seeded random weights on the card) answers 8 requests through the
   Monarch index; the launch counts are zeroed just before and read just
   after.  Then resumed prefill against full prefill through the same
   engine — held to fixed ceilings (max |diff| 0.25, at most 3% of
   logits outside rtol 1e-2/atol 5e-2) and to the greedy margin rule —
   and per-stage times.  Before it, the same comparison at full width and
   4 layers is held to rtol 1e-2/atol 5e-2 itself.
3b. gemma3's local/global stack.  Phase 3's parameters and engine are
   freed first and the card's allocated memory must be back to what it
   was before phase 3.  At full width and 8 layers (one [local x 5,
   global] group plus two local remainder blocks): 2 x 1056 prompt
   tokens, then 16 greedy decode steps at positions 1056-1071, which
   wrap the 1024-slot rings; each step's logits against a fresh full
   prefill over prompt + decoded tokens, held to rtol 1e-2/atol 5e-2;
   resumed prefill (1024 cached tokens) against full prefill, held the
   same way; the unembedding's peak memory, chunked and as one float32
   copy.  Then gemma3-27b at full width and depth (62 layers, 28.42 B
   bf16 parameters) behind ``launch/httpd.build_frontend`` on 127.0.0.1:
   8 POST /v1/generate of 2 x 96 tokens sharing a 48-token prefix from
   one client, /healthz, /stats and the graceful drain; multi-set
   launches equal the index's searches, the index hits and resumes, and
   the drain leaves every chunk resident.  The same requests through
   ``run_request_loop`` on a fresh index over the same parameters must
   give the edge's greedy tokens wherever the top-1/top-2 gap exceeds
   0.1.  Per-stage times beside the decode's weight-read bound.
3c. Logical index shards and MoE.  gemma3-27b is freed first and the
   card's allocated memory must be back to its level before phase 3.
   (a) A seeded admit/re-offer/lookup/rotate schedule through indexes of
   1, 2 and 4 shards under "auto" and "fanout" on the card, each equal to
   a one-shard CPU index after every op (planes, counters, wear state,
   hits, wear report); a lookup is one multi-set launch under "auto" and
   one per shard holding queries under "fanout"; the schedule installs,
   evicts, skips and throttles.  (b) One qwen3-moe MoE block at full
   width (128 experts, top-8), card against CPU at S = 96 (capacity 7,
   entries dropped) and S = 1: expert ids equal where the 8th/9th router
   gap exceeds 1e-6, outputs within rtol 1e-2/atol 5e-2 but for at most
   0.1% (none past 0.5: bf16 sums that cancel); then 4 MoE layers at
   full width, prefill 2 x 96 and 8 greedy decode steps, tokens equal
   under the margin rule wherever the card routed the row's tokens as the
   CPU did (bf16 noise flips routing in later layers).  (c)
   qwen3-moe-30b-a3b at full width and depth (48 layers, 30.53 B bf16
   parameters, 61.06 GB) behind ``launch/httpd.build_frontend`` with
   ``--n-shards 4``, checked and timed as phase 3b's edge.
4. The slice-2 kernels against their plain versions, exact equality, then
   timed like phase 2 beside their bounds: the hopscotch lookup (H = 4,
   32, 128 at 2^17 slots with 8,192 queries and at 2^25 slots with 2^20
   queries), the string match (edge cases, then the 500 MiB corpus with
   P = 12, 1 and 4096, and one repeated byte with P = 64) and the flat
   XAM search (the Fig. 6 shape and a 4096 x 32 x 65,536 dedup shape,
   int8 and packed8).  The edge matrices of the redesigned kernels
   (``flat_edge_cases``, ``string_edge_cases``, ``hop_edge_cases``) run
   here too; the hopscotch rows carry the sector-granular bound beside
   the byte bound, and an empty kernel is timed as the launch floor
   (``floor_ms`` of the Fig. 6, multi-set and hopscotch entries).
5. The hash table: the host and device backends through one 2,000-op
   schedule with wear tracking, bit-identical on the card; then one
   Fig. 12-14 point, ``HopscotchTable(17, window=32, backend="device")``
   filled to density 0.7 in random order and driven by 8,192 YCSB ops
   (95% reads in one lookup batch), every key found with its value, and
   lookup launches equal to the window lookups made.
6. String match and the flat-CAM API: ``stringmatch.find`` of 32 patterns
   over the 500 MiB corpus, each count equal to the plain version's, and
   one ``find`` broken down into upload, kernel, count and read-back with
   the peak device memory it adds (at most 2 N bytes);
   ``MonarchDevice()`` at its defaults filled, 256 lookups of stored keys,
   64 of absent keys and a masked search, flat launches equal to its
   ``S set=`` commands; ``dedup_mask`` at the dedup shape.
7. The memory-system simulator (``repro_torch/core/simulator.py``): the
   Fig. 9 quick sweep (7 systems x 11 CRONO/NAS apps x 40,000 requests at
   4096 blocks, two shape families) and the Fig. 11 quick pass (the M=3
   config over 11 apps, then its calibration and lifetime arithmetic on
   ``core/lifetime.py``), each family one lane-batched step replayed as
   a CUDA graph.  Every value under ``speedup_gmean``, ``hit_rate_mean``
   and ``claims`` of ``benchmarks/baselines/BENCH_fig9.json`` and under
   ``r_req_calibration``, ``years``, ``ideal_years``,
   ``ss_mechanism_ratio`` and ``claims`` of ``BENCH_fig11.json`` must be
   reproduced exactly.  Per family: wall time, µs per step replayed and
   eager (a 64-step window), kernels per step in the captured graph; and
   the peak device memory.  The path launches none of the four kernels.

Every path's launch counts are zeroed just before it and read just after.
The lines before the last are the phase reports, one JSON object with
every kernel's numbers and the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor rate
RTOL, ATOL = 1e-2, 5e-2            # the reference's non-exact bf16 bound
# Resume at full depth (48 layers of random bf16 weights) is held to fixed
# ceilings instead: the GEMMs' shape-dependent bf16 rounding, amplified by
# 48 layers, alone moves some logits past RTOL/ATOL (B=1 against B=2 full
# prefill measured max |diff| 0.117, 1.9% of logits outside on an H100).
DEEP_MAX_ABS, DEEP_MAX_OUTSIDE = 0.25, 0.03
SHALLOW_LAYERS = 4                 # resume held to RTOL/ATOL at this depth
SERVE_ARGV = ["--arch", "yi-9b", "--requests", "8", "--batch", "2",
              "--prompt-len", "96", "--decode-tokens", "8",
              "--device", "cuda"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class CudaTimer:
    """Device time of one call of ``fn``, with a cold 50 MB L2.

    ``call_ms``: CUDA events around each call, a 256 MB buffer overwritten
    before every call; median over the reps.  It includes whatever host
    time the wrapper spends after the card went idle.
    ``graph_ms``: ``reps`` calls, each behind the same overwrite, captured
    in one CUDA graph and replayed; minus a graph of the overwrites alone;
    divided by ``reps``, median over 5 replays.  Host time drops out, so
    this is the device time of the call's kernels."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def _events_ms(self, fn) -> float:
        torch = self.torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def call_ms(self, fn, reps: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            times.append(self._events_ms(fn))
        return statistics.median(times)

    def graph_ms(self, fn, reps: int = 20, flush: bool = True) -> float:
        """``flush=False`` drops the overwrites: the warm-L2 time."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        both, flush_only = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(both):
            for _ in range(reps):
                if flush:
                    self.flush.zero_()
                fn()
        t_both = statistics.median(self._events_ms(both.replay)
                                   for _ in range(5))
        if not flush:
            return t_both / reps
        with torch.cuda.graph(flush_only):
            for _ in range(reps):
                self.flush.zero_()
        t_flush = statistics.median(self._events_ms(flush_only.replay)
                                    for _ in range(5))
        return max(t_both - t_flush, 0.0) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Median wall time of ``fn`` ending in a device synchronisation."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: the search kernel against its plain version.
# ---------------------------------------------------------------------------

def search_case(np, torch, rng, n_sets, r, c, n_q, *, packed,
                empty_every=0):
    """A padded, set-grouped search batch like the index's lookup builds:
    random planes, about a third of the queries planted as valid hits,
    every ``empty_every``-th set with no valid way, the pow2 bucket tail
    of dead blocks and the all-zero mask rows of padding."""
    from repro_torch.kernels.common import pack_bits_np
    from repro_torch.kernels.xam_search import ops

    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    sets = rng.integers(0, n_sets, n_q)
    bits = rng.integers(0, 2, (n_q, r)).astype(np.int8)
    for i in range(0, n_q, 3):
        w = int(rng.integers(0, c))
        planes[sets[i], :, w] = bits[i]
        valid[sets[i], w] = 1
    if empty_every:
        valid[::empty_every] = 0
    block_q = ops._pick_block_q(n_q, None)
    keys, masks, block_sets, live, _ = ops.pack_multiset_batch(
        bits, sets, n_sets, block_q)
    padded_q = keys.shape[0]
    if packed:
        planes = pack_bits_np(planes, axis=1)
    dev = lambda x: torch.from_numpy(x).cuda()
    operands = [dev(x) for x in (keys, masks, planes, valid, block_sets,
                                 live)]
    live_sets = np.unique(block_sets[live == 1])
    plane_bytes = planes[0].nbytes
    n_bytes = (keys.nbytes + masks.nbytes + block_sets.nbytes + live.nbytes
               + len(live_sets) * (plane_bytes + c) + padded_q * 4)
    n_ops = int(masks.any(axis=1).sum()) * c * r
    return operands, block_q, n_bytes, n_ops


def check_search_kernel(np, torch) -> float:
    """Exact equality of kernel and plain version over the parity matrix;
    returns the largest absolute difference (0 when all agree)."""
    from repro_torch.kernels.xam_search import ops
    from repro_torch.kernels.xam_search.ref import xam_search_multiset_plain

    rng = np.random.default_rng(0)
    worst, n_cases = 0, 0
    shapes = [(1, 32, 512, 1), (8, 32, 512, 12), (8, 32, 512, 96),
              (32, 32, 512, 300),
              (6, 24, 96, 100), (5, 16, 96, 13), (3, 64, 700, 40),
              (128, 32, 512, 4096)]
    for n_sets, r, c, n_q in shapes:
        for packed in (False, True):
            for scoring in ("int8", "f32"):
                for empty_every in (0, 2):
                    operands, bq, _, _ = search_case(
                        np, torch, rng, n_sets, r, c, n_q, packed=packed,
                        empty_every=empty_every)
                    got = ops.xam_search_multiset_device(
                        *operands, block_q=bq, scoring=scoring)
                    want = xam_search_multiset_plain(*operands, block_q=bq)
                    torch.cuda.synchronize()
                    diff = int((got.long() - want.long()).abs().max())
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"kernel != plain at n_sets={n_sets} r={r} "
                            f"c={c} q={n_q} packed={packed} "
                            f"scoring={scoring}: max diff {diff}")
                    worst = max(worst, diff)
                    n_cases += 1
    # Random masks, random live flags and an all-zero-valid plane: the
    # launch-layout rules (dead blocks, zero-mask rows) under partial masks.
    for packed in (False, True):
        n_sets, r, c, bq, nb = 5, 32, 512, 16, 12
        planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
        planes[:, :, :40] = 0
        valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
        valid[3] = 0
        keys = rng.integers(0, 2, (nb * bq, r)).astype(np.int8)
        keys[::2] = 0
        masks = (rng.random((nb * bq, r)) < 0.25).astype(np.int8)
        masks[::7] = 0
        block_sets = rng.integers(0, n_sets, nb).astype(np.int32)
        live = (rng.random(nb) < 0.75).astype(np.int32)
        if packed:
            from repro_torch.kernels.common import pack_bits_np
            planes = pack_bits_np(planes, axis=1)
        operands = [torch.from_numpy(x).cuda() for x in (
            keys, masks, planes, valid, block_sets, live)]
        got = ops.xam_search_multiset_device(*operands, block_q=bq)
        want = xam_search_multiset_plain(*operands, block_q=bq)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain (random masks, "
                                 f"packed={packed})")
        if not bool((want >= 0).any()) or not bool((want == -1).any()):
            raise AssertionError("random-mask case exercised no hit/miss")
        n_cases += 1
    n_cases += multiset_edge_cases(np, torch)
    # The host entry point on card planes against the same on CPU planes.
    planes = rng.integers(0, 2, (8, 32, 512)).astype(np.int8)
    valid = rng.integers(0, 2, (8, 512)).astype(np.int8)
    words = rng.integers(0, 2 ** 32, 50, dtype=np.uint32)
    bits = ops.words_to_bits_np(words, 32)
    sets = rng.integers(0, 8, 50)
    planes[sets[::2], :, 7] = bits[::2]
    cuda_ways = ops.xam_search_multiset(
        bits, sets, torch.from_numpy(planes).cuda(),
        torch.from_numpy(valid).cuda())
    cpu_ways = ops.xam_search_multiset(
        bits, sets, torch.from_numpy(planes), torch.from_numpy(valid))
    if not np.array_equal(cuda_ways, cpu_ways):
        raise AssertionError("xam_search_multiset: card != CPU")
    log(f"search kernel == plain version on {n_cases + 1} cases "
        "(int8/packed8 planes, both scorings, dead blocks, zero-mask "
        "rows, empty sets; R = 1..512, C = 96..5000, block_q 16 and 100, "
        "first matches at the column vectors' and warps' edges, planes at "
        "odd addresses)")
    return float(worst)


def multiset_edge_cases(np, torch) -> int:
    """The multi-set search against its plain version at the edges of its
    design: R = 1, 24, 33, 64 and 512 (word templates), C = 96, 700 and
    5000 (ragged tails, column chunks), block_q 16 and 100 (staged query
    chunks), first matches at columns 0, 3, 4, 127, 128, 511 and C - 1,
    zero-mask rows beside hits, a dead block, int8 and packed8, and planes
    and validity at odd addresses.  Returns the number of cases."""
    from repro_torch.kernels.xam_search import ops
    from repro_torch.kernels.xam_search.ref import xam_search_multiset_plain

    from repro_torch.kernels.edge_cases import multiset_edge_case
    n_cases = 0
    for r in (1, 24, 33, 64, 512):
        for c, bq in ((96, 16), (700, 16), (700, 100), (5000, 16)):
            for packed in (False, True):
                *arrays, firsts = multiset_edge_case(r + c, r, c, bq, packed)
                operands = [torch.from_numpy(x).cuda() for x in arrays]
                got = ops.xam_search_multiset_device(*operands, block_q=bq)
                want = xam_search_multiset_plain(*operands, block_q=bq)
                assert_equal(torch, got, want, f"multi-set search r={r} c={c} "
                             f"block_q={bq} packed={packed}")
                if got[:len(firsts) * bq:bq].tolist() != firsts:
                    raise AssertionError("a planted first match was missed")
                n_cases += 1
                if (r, c) == (64, 700):          # the same at odd addresses
                    for i in (2, 3):
                        t = operands[i]
                        store = torch.empty(t.numel() + 1, dtype=t.dtype,
                                            device="cuda")
                        operands[i] = store[1:].view(t.shape)
                        operands[i].copy_(t)
                    assert_equal(torch, ops.xam_search_multiset_device(
                        *operands, block_q=bq), want,
                        f"multi-set search, odd addresses, packed={packed}")
                    n_cases += 1
    return n_cases


def time_search_kernel(np, torch, timer) -> list[dict]:
    from repro_torch.kernels.xam_search import ops
    from repro_torch.kernels.xam_search.ref import xam_search_multiset_plain

    rng = np.random.default_rng(1)
    out = []
    for name, n_sets, n_q in [("main path (2 x 96-token prompts)", 8, 12),
                              ("launcher geometry", 8, 96),
                              ("KVIndexConfig defaults", 32, 256),
                              ("one-card index, 65536 slots", 128, 4096)]:
        for packed in (False, True):
            operands, bq, n_bytes, n_ops = search_case(
                np, torch, rng, n_sets, 32, 512, n_q, packed=packed)
            kern = lambda: ops.xam_search_multiset_device(*operands,
                                                          block_q=bq)
            plain = lambda: xam_search_multiset_plain(*operands, block_q=bq)
            call_ms, plain_call_ms = timer.call_ms(kern), timer.call_ms(plain)
            ms, plain_ms = timer.graph_ms(kern), timer.graph_ms(plain)
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / INT8_OPS_PER_S * 1e3
            row = {"shape": name, "n_sets": n_sets, "set_ways": 512,
                   "key_bits": 32, "queries": n_q,
                   "padded_queries": int(operands[0].shape[0]),
                   "block_q": bq,
                   "plane_format": "packed8" if packed else "int8",
                   "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                   "plain_call_ms": plain_call_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": n_bytes}
            out.append(row)
            log(f"time {name} ({row['plane_format']}, Q={n_q}): kernel "
                f"{ms:.5f} ms (per call with host {call_ms:.5f}), plain "
                f"{plain_ms:.5f} ms ({plain_call_ms:.5f}), bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}, "
                f"{n_bytes} B)")
    return out


# ---------------------------------------------------------------------------
# Phase 3: serve at yi-9b full width.
# ---------------------------------------------------------------------------

def shallow_resume_check(np, torch) -> dict:
    """Resumed against full prefill at yi-9b full width and
    ``SHALLOW_LAYERS`` layers, held to RTOL/ATOL and the greedy margin
    rule.  As in serving, the prefix KV comes from an earlier prompt that
    shares the 48-token prefix and differs after it."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch("yi-9b"), n_layers=SHALLOW_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, cfg.vocab_size, (2, 48))
    first, second = (np.concatenate(
        [prefix, rng.integers(1, cfg.vocab_size, (2, 48))], axis=1)
        for _ in range(2))
    _, _, kv = transformer.prefill(params, cfg, {"tokens": first}, 104,
                                   return_kv=True)
    prefix_kv = {"groups": {"b0": {n: t[:, :, :48].contiguous() for n, t in
                                   kv["groups"]["b0"].items()}}}
    resumed, cache_r = transformer.prefill(
        params, cfg, {"tokens": second[:, 48:]}, 104, prefix_kv=prefix_kv)
    full, cache_f = transformer.prefill(params, cfg, {"tokens": second}, 104)
    a, b = resumed.float().cpu().numpy(), full.float().cpu().numpy()
    if not np.isfinite(a).all() or not np.isfinite(b).all():
        raise AssertionError("non-finite logits")
    d_logits = float(np.abs(a - b).max())
    out = float((np.abs(a - b) > ATOL + RTOL * np.abs(b)).mean())
    ck_r = cache_r["groups"]["b0"]["k"][:, :, :96].float()
    ck_f = cache_f["groups"]["b0"]["k"][:, :, :96].float()
    d_cache = float((ck_r - ck_f).abs().max())
    cache_ok = bool(torch.allclose(ck_r, ck_f, rtol=RTOL, atol=ATOL))
    gap = np.sort(b, axis=-1)[:, -2:]
    clear = (gap[:, 1] - gap[:, 0]) > 0.1
    log(f"resumed vs full prefill at full width, {SHALLOW_LAYERS} layers: "
        f"logits max |diff| {d_logits:.6f}, {out:.6f} outside rtol {RTOL}/"
        f"atol {ATOL}; cache k max |diff| {d_cache:.6f}")
    if out > 0 or not cache_ok:
        raise AssertionError(
            f"resumed vs full prefill at {SHALLOW_LAYERS} layers exceed "
            f"rtol {RTOL}/atol {ATOL}: logits max |diff| {d_logits}, cache "
            f"max |diff| {d_cache}")
    if not (a.argmax(-1) == b.argmax(-1))[clear].all():
        raise AssertionError("resumed and full prefill disagree on a greedy "
                             "token whose top-1/top-2 gap exceeds 0.1")
    del params, kv, prefix_kv, cache_r, cache_f
    torch.cuda.empty_cache()
    return {"layers": SHALLOW_LAYERS, "max_abs_diff": d_logits,
            "outside_tol": out, "cache_max_abs_diff": d_cache}


def serve_phase(np, torch) -> dict:
    from repro_torch.kernels.xam_search import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_leaves

    args = serve.parse_args(SERVE_ARGV)
    ops.LAUNCH_COUNT = 0
    ops.ADMIT_LAUNCH_COUNT = 0
    run = serve.serve(args)
    launches = ops.LAUNCH_COUNT
    admit_launches = ops.ADMIT_LAUNCH_COUNT
    cfg, idx, eng, recs = run.cfg, run.index, run.engine, run.records

    dims = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size)
    if dims != (48, 4096, 32, 4, 128, 11008, 64000):
        raise AssertionError(f"not yi-9b at full width and depth: {dims}")
    leaves = tree_leaves(run.params)
    if not all(t.is_cuda and t.dtype == torch.bfloat16 for t in leaves):
        raise AssertionError("a parameter is off the card or not bf16")
    for name in ("bits", "valid", "fp_of", "read_after", "set_writes",
                 "counter"):
        if not getattr(idx, name).is_cuda:
            raise AssertionError(f"index plane {name} is off the card")
    s = idx.stats
    if launches != s.searches or launches == 0:
        raise AssertionError(f"LAUNCH_COUNT grew by {launches}, "
                             f"stats.searches={s.searches}")
    if idx.hit_rate <= 0:
        raise AssertionError("no index hits")
    if sum(r.resumed_chunks for r in recs[1:]) <= 0:
        raise AssertionError("no resumed chunks after the first batch")
    for r in recs:
        if r.decoded is None or r.decoded.shape != (2, 8):
            raise AssertionError(f"decoded shape {getattr(r.decoded, 'shape', None)}")
        if r.decoded.min() < 0 or r.decoded.max() >= cfg.vocab_size:
            raise AssertionError("decoded token out of the vocabulary")
    report = idx.slab_lockstep_report()
    if report["missing_slabs"] or report["orphan_slabs"]:
        raise AssertionError(f"slab lockstep broken: {report}")
    n_params = transformer.param_count(run.params)
    log(f"served {len(recs)} batches of 2 at yi-9b full width "
        f"({n_params / 1e9:.3f} B params, 48 layers): hit rate "
        f"{idx.hit_rate:.3f}, {s.searches} searches == {launches} kernel "
        f"launches, {admit_launches} admission dispatches, resumed chunks "
        f"{[r.resumed_chunks for r in recs]}")

    # Resumed against full prefill, through the same engine, on a batch
    # whose shared-prefix chunks are resident.
    toks = run.batches[-1]
    hits = idx.lookup(toks)
    resumed = eng.prefill(toks, hits)
    full = eng.prefill(toks, None)
    if resumed.resumed_chunks <= 0:
        raise AssertionError("the check batch resumed no chunk")
    a = resumed.state["logits"].float().cpu().numpy()
    b = full.state["logits"].float().cpu().numpy()
    if not np.isfinite(a).all() or not np.isfinite(b).all():
        raise AssertionError("non-finite logits")
    # Noise floor of the same computation at another GEMM shape, reported
    # beside the resume difference: the full prefill of each row alone
    # (B=1) against the batch of two.
    rows = np.concatenate([eng.prefill(toks[r:r + 1], None).state["logits"]
                           .float().cpu().numpy() for r in range(2)])
    over = lambda x, y: float((np.abs(x - y) > ATOL + RTOL * np.abs(y)).mean())
    d_res, d_floor = float(np.abs(a - b).max()), float(np.abs(rows - b).max())
    gap = np.sort(b, axis=-1)[:, -2:]
    clear = (gap[:, 1] - gap[:, 0]) > 0.1       # the greedy margin rule
    dec_r = eng.decode(resumed, 8)
    dec_f = eng.decode(full, 8)
    agree = float((dec_r == dec_f).mean())
    log(f"resumed ({resumed.resumed_chunks} chunks from slabs) vs full "
        f"prefill: last-token logits max |diff| {d_res:.6f}, "
        f"{over(a, b):.5f} of logits outside rtol {RTOL}/atol {ATOL}; "
        f"noise floor (full prefill, B=1 vs B=2) max |diff| {d_floor:.6f}, "
        f"{over(rows, b):.5f} outside; decoded tokens agree {agree:.3f} "
        "of 16")
    if d_res > DEEP_MAX_ABS or over(a, b) > DEEP_MAX_OUTSIDE:
        raise AssertionError(
            f"resumed vs full prefill at 48 layers: max |diff| {d_res} "
            f"(ceiling {DEEP_MAX_ABS}), {over(a, b)} of logits outside "
            f"rtol/atol (ceiling {DEEP_MAX_OUTSIDE})")
    if not (a.argmax(-1) == b.argmax(-1))[clear].all():
        raise AssertionError("resumed and full prefill disagree on a greedy "
                             "token whose top-1/top-2 gap exceeds 0.1")

    # Per-stage times (host clock, each ending in a synchronisation).
    fresh = np.random.default_rng(5).integers(
        1, 2 ** 32, (16, 12), dtype=np.uint32)
    it = iter(fresh)
    times = {
        "lookup_ms": host_ms(torch, lambda: idx.lookup(toks), 10),
        "prefill_resumed_ms": host_ms(torch, lambda: eng.prefill(toks, hits),
                                      3),
        "prefill_full_ms": host_ms(torch, lambda: eng.prefill(toks, None),
                                   3),
        "decode_ms_per_token": host_ms(
            torch, lambda: eng.decode(full, 8), 3) / 8,
        "admit_ms": host_ms(torch, lambda: idx.admit_fps(next(it)), 10),
        "serve_loop_s": run.seconds,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("stage times: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return {"launches": launches, "batches": len(recs), "times": times,
            "resume_check": {"max_abs_diff": d_res, "outside_tol": over(a, b),
                             "floor_max_abs_diff": d_floor,
                             "floor_outside_tol": over(rows, b),
                             "decoded_agree": agree}}


# ---------------------------------------------------------------------------
# Phase 3b: gemma3-27b's local/global stack, served through the HTTP edge.
# ---------------------------------------------------------------------------

GEMMA_RING_LAYERS = 8              # one [local x 5, global] group + rem0, rem1
GEMMA_RING_PROMPT = 1056           # > the 1024-token window: the ring wraps
GEMMA_RING_PREFIX = 1024           # resumed-prefill check: 64 chunks cached
GEMMA_RING_STEPS = 16              # decode positions 1056-1071
EDGE_REQUESTS = 8                  # POST /v1/generate, 2 x 96 tokens each
EDGE_ARGV = ["--arch", "gemma3-27b", "--device", "cuda", "--host",
             "127.0.0.1", "--port", "0", "--prompt-len", "96",
             "--decode-tokens", "8", "--admit-after-reads", "0"]


GEMMA_DIMS = {"n_layers": 62, "d_model": 5376, "n_heads": 32,
              "n_kv_heads": 16, "d_head": 128, "d_ff": 21504,
              "vocab_size": 262144, "sliding_window": 1024}


def gemma_tree(params) -> None:
    if sorted(params["groups"]) != [f"b{i}" for i in range(6)] or \
            params["groups"]["b0"]["attn"]["wq"].shape[0] != 10 or \
            "rem1" not in params or "rem2" in params:
        raise AssertionError("gemma3-27b's tree is not 10 x b0..b5 + rem0/1")


def free_card(torch) -> int:
    """Collect what the last phase left, drop cuBLAS's workspaces (one
    per thread that ran a GEMM: the edge's two router workers leave 2 x
    32 MiB) and empty the caching allocator's free blocks; returns the
    device memory still allocated."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def greedy_margin_agree(got, want, gaps) -> bool:
    """Row by row, tokens equal until the first step whose reference
    top-1/top-2 gap is within 0.1; a row is not compared past a permitted
    divergence."""
    for r in range(want.shape[0]):
        for t in range(want.shape[1]):
            if got[r, t] != want[r, t]:
                if gaps[r, t] > 0.1:
                    return False
                break
    return True


def top2_gap(np, logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def gemma_ring_check(np, torch) -> dict:
    """gemma3-27b at full width and ``GEMMA_RING_LAYERS`` layers: prefill
    2 x 1056 tokens, decode 16 greedy tokens (positions 1056-1071 wrap the
    1024-slot rings), each step's logits held to RTOL/ATOL against the
    last-token logits of a fresh full prefill over prompt + decoded
    tokens (the windowed prefill does not use the ring).  Then resumed
    prefill (1024 tokens from the prefix KV) against full prefill, held
    to RTOL/ATOL and the greedy margin rule; and the peak device memory
    of one unembedding at the 262,144-token vocabulary, chunked as the
    port does it and as one float32 copy of the weight."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers, transformer
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch("gemma3-27b"),
                              n_layers=GEMMA_RING_LAYERS)
    group, n_groups, rem = cfg.scan_groups()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    if (n_groups, len(group), len(rem)) != (1, 6, 2) or \
            sorted(params) != ["embed", "final_ln", "groups", "rem0", "rem1"]:
        raise AssertionError(f"unexpected 8-layer tree: {sorted(params)}")
    rng = np.random.default_rng(11)
    s0, n = GEMMA_RING_PROMPT, GEMMA_RING_STEPS
    max_seq = s0 + n
    seq = rng.integers(1, cfg.vocab_size, (2, s0))
    logits, cache = transformer.prefill(params, cfg, {"tokens": seq},
                                        max_seq)
    ring = cache["groups"]["b0"]["k"]
    if ring.shape[2] != cfg.sliding_window:
        raise AssertionError(f"local ring of {ring.shape[2]} slots")
    d_max, out_max = 0.0, 0.0
    for t in range(n):
        nxt = logits.argmax(-1).cpu().numpy()[:, None]
        seq = np.concatenate([seq, nxt], axis=1)
        logits, cache = transformer.decode_step(params, cfg, nxt, cache,
                                                s0 + t)
        full, _ = transformer.prefill(params, cfg, {"tokens": seq}, max_seq)
        a, b = logits.float().cpu().numpy(), full.float().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite decode logits at step {t}")
        d_max = max(d_max, float(np.abs(a - b).max()))
        out_max = max(out_max, float(
            (np.abs(a - b) > ATOL + RTOL * np.abs(b)).mean()))
    log(f"ring decode at full width, {GEMMA_RING_LAYERS} layers, positions "
        f"{s0}-{s0 + n - 1} over {cfg.sliding_window}-slot rings vs full "
        f"prefill: logits max |diff| {d_max:.6f}, {out_max:.6f} outside "
        f"rtol {RTOL}/atol {ATOL}")
    if out_max > 0:
        raise AssertionError(f"ring decode vs full prefill exceeds rtol "
                             f"{RTOL}/atol {ATOL}: max |diff| {d_max}")

    # Resumed against full prefill over a prompt sharing 1024 tokens.
    p = GEMMA_RING_PREFIX
    first = seq[:, :s0]
    second = np.concatenate([first[:, :p], rng.integers(
        1, cfg.vocab_size, (2, s0 - p))], axis=1)
    _, _, kv = transformer.prefill(params, cfg, {"tokens": first}, max_seq,
                                   return_kv=True)
    prefix_kv = tree_map(lambda a: a[..., :p, :, :].contiguous(), kv)
    resumed, cache_r = transformer.prefill(
        params, cfg, {"tokens": second[:, p:]}, max_seq, prefix_kv=prefix_kv)
    full, cache_f = transformer.prefill(params, cfg, {"tokens": second},
                                        max_seq)
    a, b = resumed.float().cpu().numpy(), full.float().cpu().numpy()
    d_res = float(np.abs(a - b).max())
    res_out = float((np.abs(a - b) > ATOL + RTOL * np.abs(b)).mean())
    d_cache = max(float((x.float() - y.float()).abs().max()) for x, y in
                  zip(tree_leaves(cache_r), tree_leaves(cache_f)))
    cache_ok = all(torch.allclose(x.float(), y.float(), rtol=RTOL, atol=ATOL)
                   for x, y in zip(tree_leaves(cache_r),
                                   tree_leaves(cache_f)))
    clear = top2_gap(np, b) > 0.1
    log(f"resumed ({p} tokens from the prefix KV) vs full prefill at "
        f"{GEMMA_RING_LAYERS} layers: logits max |diff| {d_res:.6f}, "
        f"{res_out:.6f} outside; cache max |diff| {d_cache:.6f}")
    if res_out > 0 or not cache_ok:
        raise AssertionError(f"resumed vs full prefill at "
                             f"{GEMMA_RING_LAYERS} layers exceeds rtol/atol")
    if not (a.argmax(-1) == b.argmax(-1))[clear].all():
        raise AssertionError("resumed and full prefill disagree on a greedy "
                             "token whose top-1/top-2 gap exceeds 0.1")

    # The unembedding's transient: chunked (the port) and one float32
    # copy of the whole weight (before this slice).
    x = torch.randn((2, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    w = params["embed"]["unembed"]
    peak_chunked = added_peak_bytes(
        torch, lambda: layers.unembed_logits(params["embed"], x))
    peak_copy = added_peak_bytes(
        torch, lambda: torch.einsum("bsd,dv->bsv", x.float(), w.float()))
    log(f"unembedding at vocab {cfg.vocab_size}: peak added "
        f"{peak_chunked / 1e9:.4f} GB chunked, {peak_copy / 1e9:.4f} GB "
        "as one float32 copy")
    del params, cache, kv, prefix_kv, cache_r, cache_f, ring
    return {"layers": GEMMA_RING_LAYERS, "window": cfg.sliding_window,
            "decode_positions": [s0, s0 + n - 1],
            "decode_vs_full_max_abs_diff": d_max,
            "decode_vs_full_outside_tol": out_max,
            "resumed_max_abs_diff": d_res, "resumed_outside_tol": res_out,
            "resumed_cache_max_abs_diff": d_cache,
            "unembed_peak_bytes_chunked": peak_chunked,
            "unembed_peak_bytes_float32_copy": peak_copy}


def http_json(method: str, host: str, port: int, path: str, body=None):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    doc = json.loads(resp.read())
    conn.close()
    return resp.status, doc


def edge_phase(np, torch, smi: str, argv: list, dims: dict,
               check_tree) -> dict:
    """The ``--arch`` of ``argv`` at full width and depth (its fields
    must equal ``dims``; bf16, seeded random weights on the card, their
    tree checked by ``check_tree``) booted behind
    ``launch/httpd.build_frontend`` on 127.0.0.1, port 0: 8 POST
    /v1/generate of 2 x 96 tokens sharing a 48-token prefix from one
    client, then /healthz, /stats and the graceful drain.  The launch
    counts are zeroed just before the boot and read after the drain.  The
    same 8 requests are then replayed through ``run_request_loop`` on a
    fresh index of the same shards over the same parameters (greedy
    tokens equal under the margin rule), and the per-stage times are
    taken on that engine."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.xam_search import ops
    from repro_torch.launch import httpd
    from repro_torch.launch.serve import build_model_fns, run_request_loop
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_leaves
    from repro_torch.serve.admit_queue import AdmitQueue
    from repro_torch.serve.kv_index import (KVIndexConfig, KVSlabStore,
                                            MonarchKVIndex)

    args = httpd.build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    got = {k: getattr(cfg, k) for k in dims}
    if got != dims:
        raise AssertionError(f"not {cfg.name} at full width: {got}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = transformer.param_count(params)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    check_tree(params)
    log(f"{cfg.name}: {n_params / 1e9:.4f} B params ({weight_bytes / 1e9:.3f}"
        f" GB bf16) drawn on the card in {init_s:.1f} s")

    rng = np.random.default_rng(0)
    prefix = rng.integers(1, cfg.vocab_size, 48)
    batches = [np.concatenate([np.tile(prefix, (2, 1)), rng.integers(
        1, cfg.vocab_size, (2, 48))], axis=1).astype(np.int32)
        for _ in range(EDGE_REQUESTS)]

    zero_counts()
    frontend, admit_q = httpd.build_frontend(args, params=params)
    idx = admit_q.index
    frontend.start()
    host, port = frontend.address
    answers, latency_ms = [], []
    for toks in batches:
        t0 = time.perf_counter()
        status, doc = http_json("POST", host, port, "/v1/generate",
                                {"tokens": toks.tolist()})
        latency_ms.append((time.perf_counter() - t0) * 1e3)
        if status != 200:
            raise AssertionError(f"POST /v1/generate answered {status}: {doc}")
        answers.append(doc)
    h_status, health = http_json("GET", host, port, "/healthz")
    s_status, stats = http_json("GET", host, port, "/stats")
    if h_status != 200 or health["status"] != "ok" or s_status != 200:
        raise AssertionError(f"/healthz {h_status}, /stats {s_status}")
    t0 = time.perf_counter()
    frontend.shutdown()                  # drain router + admissions
    admit_q.close()
    drain_s = time.perf_counter() - t0
    launches = read_counts()
    s = idx.stats
    served = frontend.router.stats
    edge_tokens = [np.asarray(a["tokens"]) for a in answers]
    if launches["xam_search_multiset"] != s.searches or s.searches == 0:
        raise AssertionError(f"multi-set launches {launches} != "
                             f"stats.searches {s.searches}")
    if idx.hit_rate <= 0 or sum(a["resumed_chunks"] for a in answers[1:]) <= 0:
        raise AssertionError("no index hits or no resumed chunks")
    if served.completed != EDGE_REQUESTS or served.errors:
        raise AssertionError(f"router: {served}")
    if s.throttled:
        raise AssertionError(f"{s.throttled} admissions throttled")
    for tk in edge_tokens:
        if tk.shape != (2, 8) or tk.min() < 0 or tk.max() >= cfg.vocab_size:
            raise AssertionError(f"decoded tokens {tk.shape}")
    # The drain completed every admission: nothing pending, every chunk
    # of every request resident with its slab.
    report = idx.slab_lockstep_report()
    chunks = {int(f) for t in batches for f in idx.fingerprints(t).ravel()}
    if admit_q.pending() or report["missing_slabs"] or \
            report["orphan_slabs"] or not chunks <= set(idx.slot_of):
        raise AssertionError(f"drain lost admissions: {report}")
    if (idx.n_shards, idx.n_parts) != (args.n_shards, 1):
        raise AssertionError(f"index of {idx.n_shards} shards in "
                             f"{idx.n_parts} partitions")
    log(f"edge: {EDGE_REQUESTS} requests at {cfg.name} full depth, "
        f"{idx.n_shards} index shards, hit rate "
        f"{idx.hit_rate:.3f}, {s.searches} searches == "
        f"{launches['xam_search_multiset']} launches, resumed chunks "
        f"{[a['resumed_chunks'] for a in answers]}, drain {drain_s:.2f} s, "
        f"/stats hit rate {stats['index']['hit_rate']}")

    # The same requests through run_request_loop on a fresh index.
    kv_cfg = KVIndexConfig(n_sets=8, m_writes=args.m_writes,
                           clock=args.wear_clock, fingerprint="prefix",
                           admit_after_reads=0, n_shards=args.n_shards)
    idx2 = MonarchKVIndex(kv_cfg, slab_store=KVSlabStore(), device="cuda")
    q2 = AdmitQueue(idx2)
    max_seq = args.prompt_len + args.decode_tokens
    prefill_fn, _, eng = build_model_fns(
        params, cfg, max_seq=max_seq, decode_tokens=8, index=idx2,
        resume=True)
    gaps = []

    def decode_fn(toks, result):
        st = result.state
        logits, cache, pos = st["logits"], st["cache"], st["pos"]
        out, g = [], []
        for t in range(8):
            lg = logits.float().cpu().numpy()
            out.append(lg.argmax(-1))
            g.append(top2_gap(np, lg))
            if t < 7:
                nxt = torch.from_numpy(out[-1][:, None]).cuda()
                _, logits, cache = eng._decode(params, cache, nxt, pos + t)
        gaps.append(np.stack(g, 1))
        return np.stack(out, 1).astype(np.int32)

    recs = run_request_loop(q2, batches, prefill_fn=prefill_fn,
                            decode_fn=decode_fn)
    q2.flush()
    for i, (rec, tk) in enumerate(zip(recs, edge_tokens)):
        if not greedy_margin_agree(tk, rec.decoded, gaps[i]):
            raise AssertionError(f"request {i}: the edge's greedy tokens "
                                 "differ from the replay's where the "
                                 "top-1/top-2 gap exceeds 0.1")
    agree = float(np.mean([(tk == r.decoded).mean()
                           for tk, r in zip(edge_tokens, recs)]))

    # Per-stage times on the replay's engine (host clock, each ending in
    # a synchronisation).
    toks = batches[-1]
    hits = idx2.lookup(toks)
    full = eng.prefill(toks, None)
    resumed_timed = eng.prefill(toks, hits).resumed_chunks
    fresh = np.random.default_rng(5).integers(1, 2 ** 32, (16, 12),
                                              dtype=np.uint32)
    it = iter(fresh)
    times = {
        "lookup_ms": host_ms(torch, lambda: idx2.lookup(toks), 10),
        "prefill_resumed_ms": host_ms(torch, lambda: eng.prefill(toks, hits),
                                      3),
        "prefill_full_ms": host_ms(torch, lambda: eng.prefill(toks, None), 3),
        "decode_ms_per_token": host_ms(
            torch, lambda: eng.decode(full, 8), 3) / 8,
        "admit_ms": host_ms(torch, lambda: idx2.admit_fps(next(it)), 10),
        "edge_latency_ms": latency_ms,
        "edge_latency_ms_median": statistics.median(latency_ms),
        "edge_server_ms": [a["server_ms"] for a in answers],
        "resumed_chunks_timed": resumed_timed,
        "init_s": init_s, "drain_s": drain_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
    }
    q2.close()
    log("edge stage times (" + smi + "): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float)))
    return {"arch": cfg.name, "n_shards": idx.n_shards,
            "launches": launches["xam_search_multiset"],
            "searches": s.searches, "requests": EDGE_REQUESTS,
            "hit_rate": idx.hit_rate,
            "resumed_chunks": [a["resumed_chunks"] for a in answers],
            "params_b": n_params / 1e9, "weight_gb": weight_bytes / 1e9,
            "decoded_agree": agree, "times": times, "card": smi}


def gemma_phase(np, torch, smi: str, base_bytes: int) -> dict:
    """Phase 3b: free the card of phase 3, then the ring check at 8
    layers and the edge at full depth."""
    left = free_card(torch)
    log(f"phase 3b: {left / 1e9:.4f} GB allocated after phase 3 "
        f"(before it: {base_bytes / 1e9:.4f} GB)")
    if left > base_bytes + (64 << 20):
        raise AssertionError(f"phase 3 left {left - base_bytes} bytes on "
                             "the card")
    t0 = time.perf_counter()
    ring = gemma_ring_check(np, torch)
    free_card(torch)
    edge = edge_phase(np, torch, smi, EDGE_ARGV, GEMMA_DIMS, gemma_tree)
    free_card(torch)
    log(f"phase 3b: {time.perf_counter() - t0:.1f} s")
    return {"ring_check": ring, "edge": edge,
            "allocated_after_phase3_bytes": left,
            "allocated_before_phase3_bytes": base_bytes}


# ---------------------------------------------------------------------------
# Phase 3c: logical index shards, the MoE block, qwen3-moe behind the edge.
# ---------------------------------------------------------------------------

SHARD_STEPS = 24                   # randomized admit/lookup/rotate ops
SHARD_CFG = dict(n_sets=8, set_ways=4, admit_after_reads=1, m_writes=1,
                 window_ops=64, rotate_every=1 << 30)
ROUTE_MARGIN = 1e-6                # k-th vs (k+1)-th router probability
# The full-width MoE block, card against CPU, is held to RTOL/ATOL with
# fixed ceilings on what falls outside, as the deep resume check is: its
# outputs (median |y| 6.5, up to 54) are sums of up to 8 gated bf16
# expert outputs, and where they cancel, one bf16 ulp of a contribution
# that the GEMMs' accumulation order moved (0.11% of cuBLAS's bf16 bmm
# outputs differ from a float64 product by an ulp, 0.02% of the CPU's)
# exceeds the bound on the small sum.  Two CPU runs whose only difference
# is the GEMMs' rounding already put 0.003% of elements outside, max
# |diff| 0.25; the card put 0.038% outside, max 0.25.
MOE_MAX_ABS, MOE_MAX_OUTSIDE = 0.5, 1e-3
MOE_PREFILL = 96                   # capacity 7 at top-8 of 128: drops
MOE_LAYERS = 4
MOE_DECODE = 8
QWEN_DIMS = {"n_layers": 48, "d_model": 2048, "n_heads": 32,
             "n_kv_heads": 4, "d_head": 128, "n_experts": 128, "top_k": 8,
             "moe_d_ff": 768, "vocab_size": 151936}
MOE_EDGE_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--device", "cuda",
                 "--host", "127.0.0.1", "--port", "0", "--prompt-len", "96",
                 "--decode-tokens", "8", "--admit-after-reads", "0",
                 "--n-shards", "4"]


def index_state(np, idx) -> dict:
    """An index's global state on the host: planes, counters, every wear
    field, the shadow map, the stats and the wear report."""
    ws = idx.wear_state
    wear = {f.name: (getattr(ws, f.name).cpu().numpy() if f.name != "offsets"
                     else [int(getattr(ws.offsets, g.name)) for g in
                           dataclasses.fields(ws.offsets)])
            for f in dataclasses.fields(ws)}
    return {"bits": idx.bits.cpu().numpy(), "valid": idx.valid.cpu().numpy(),
            "fp_of": idx.fp_of.cpu().numpy(),
            "read_after": idx.read_after.cpu().numpy(),
            "set_writes": idx.set_writes.cpu().numpy(),
            "counter": idx.counter.cpu().numpy(), "wear": wear,
            "slot_of": dict(idx.slot_of), "offset": idx.offset,
            "report": idx.wear_report(),
            "stats": (idx.stats.admissions, idx.stats.admission_skips,
                      idx.stats.throttled, idx.stats.evictions,
                      idx.stats.chunk_hits, idx.stats.rotations)}


def same_state(np, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(np, a[k], b[k])
                                            for k in a)
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype and \
            bool((a == b).all())
    return a == b


def shard_check(np, torch) -> dict:
    """(a) Logical shards on the card: one seeded admit/re-offer/lookup/
    rotate schedule through indexes of 1, 2 and 4 shards under "auto"
    and "fanout", all on the card, beside a one-shard index on the CPU.
    After every op every card index's global state equals the CPU's; a
    lookup is one multi-set launch under "auto" and one per shard
    holding queries under "fanout".  The schedule must install, evict,
    skip (no-allocate) and throttle."""
    from repro_torch.data.pipeline import fingerprint_blocks
    from repro_torch.kernels.xam_search import ops
    from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                            MonarchKVIndex)

    idxs = {(n, d): MonarchKVIndex(KVIndexConfig(n_shards=n, **SHARD_CFG),
                                   dispatch=d, device="cuda")
            for n in (1, 2, 4) for d in ("auto", "fanout")}
    cpu = MonarchKVIndex(KVIndexConfig(**SHARD_CFG), device="cpu")
    every = [cpu, *idxs.values()]
    rng = np.random.default_rng(17)
    per_lookup = {"auto": [], "fanout": []}
    t0 = time.perf_counter()
    for step in range(SHARD_STEPS):
        toks = rng.integers(1, 600, (2, 6 * CHUNK_TOKENS)).astype(np.int32)
        op = rng.random()
        if op < 0.6:
            fps = np.unique(fingerprint_blocks(toks, CHUNK_TOKENS).ravel())
            for _ in range(2 if op < 0.4 else 1):   # a re-offer
                for idx in every:
                    idx.admit_fps(fps)
        elif op < 0.9:
            want = cpu.lookup(toks)
            sets = cpu._set_of(cpu.fingerprints(toks).ravel())
            for (n, d), idx in idxs.items():
                before = ops.LAUNCH_COUNT
                got = idx.lookup(toks)
                made = ops.LAUNCH_COUNT - before
                expect = (1 if d == "auto" else
                          len(np.unique(sets // idx.sets_per_part)))
                if made != expect:
                    raise AssertionError(f"{n} shards, {d}: {made} search "
                                         f"launches, expected {expect}")
                if not np.array_equal(got, want):
                    raise AssertionError(f"{n} shards, {d}: hits differ")
                per_lookup[d].append(made)
        else:
            for idx in every:
                idx._rotate()
        want = index_state(np, cpu)
        for (n, d), idx in idxs.items():
            if not same_state(np, index_state(np, idx), want):
                raise AssertionError(f"step {step}: the card's {n}-shard "
                                     f"{d} index differs from the CPU's")
    st = cpu.stats
    if not (st.admissions and st.evictions and st.admission_skips
            and st.throttled and st.rotations and per_lookup["auto"]):
        raise AssertionError(f"schedule too tame: {st}")
    # Host-clock times at 4 shards: a 12-chunk lookup, and the admission
    # of 12 fresh fingerprints (one round-grid dispatch under "auto",
    # the per-candidate scans of each partition under "fanout").
    fresh = iter(rng.integers(1, 2 ** 32, (40, 12), dtype=np.uint32))
    before = ops.LAUNCH_COUNT
    times = {d: {"lookup_ms": host_ms(torch, lambda: idxs[4, d].lookup(
                     toks), 10),
                 "admit_ms": host_ms(torch, lambda: idxs[4, d].admit_fps(
                     next(fresh)), 10)}
             for d in ("auto", "fanout")}
    timing_launches = ops.LAUNCH_COUNT - before
    log(f"shards: {SHARD_STEPS} ops at 1/2/4 shards, auto and fanout on "
        f"the card equal the CPU after every op; launches per lookup "
        f"auto {per_lookup['auto']}, fanout {per_lookup['fanout']}; "
        f"{st.admissions} installs, {st.evictions} evictions, "
        f"{st.admission_skips} skips, {st.throttled} throttles; at 4 "
        f"shards lookup / admission of 12 ms: auto "
        f"{times['auto']['lookup_ms']:.4f} / {times['auto']['admit_ms']:.4f}"
        f", fanout {times['fanout']['lookup_ms']:.4f} / "
        f"{times['fanout']['admit_ms']:.4f}")
    lookups = len(per_lookup["auto"]) // 3
    return {"ops": SHARD_STEPS, "lookups": lookups,
            "launches_per_lookup": per_lookup,
            "launches": sum(per_lookup["auto"]) + sum(per_lookup["fanout"]),
            "cpu_plain_runs": lookups, "timing_launches": timing_launches,
            "installs": st.admissions, "evictions": st.evictions,
            "skips": st.admission_skips, "throttles": st.throttled,
            "rotations": st.rotations, "times_at_4_shards": times,
            "seconds": time.perf_counter() - t0}


def routing_masks(np, probs, k: int, ix):
    """From the CPU's router probabilities (G, N, E) and expert ids
    (G, N, K): the tokens whose k-th/(k+1)-th gap exceeds the margin, the
    tokens whose whole top k+1 is ordered past it, and the tokens whose
    output a near tie could change: the tied token, and its group's
    tokens routed to either of the tied experts (their rank in that
    expert, hence their drops, may move)."""
    top = np.sort(probs, axis=-1)[..., ::-1][..., :k + 1]
    order = np.argsort(-probs, axis=-1, kind="stable")[..., :k + 1]
    gaps = top[..., :-1] - top[..., 1:]
    decided = gaps[..., k - 1] > ROUTE_MARGIN
    ordered = (gaps > ROUTE_MARGIN).all(-1)
    clean = decided.copy()
    for g, n in zip(*np.nonzero(~decided)):
        tied = order[g, n, k - 1:k + 1]
        clean[g] &= ~np.isin(ix[g], tied).any(-1)
    return decided, ordered, clean


def moe_layer_check(np, torch) -> dict:
    """(b) One qwen3-moe MoE block at full width (d_model 2048, 128
    experts, top-8, moe_d_ff 768; seeded weights drawn on the card) on
    the card and on the CPU, same weights and inputs: expert ids equal
    where the routing is decided past ``ROUTE_MARGIN``; where no near tie
    can reach them, outputs within RTOL/ATOL but for at most
    ``MOE_MAX_OUTSIDE`` of them, none further than ``MOE_MAX_ABS``; at
    S = 96 (capacity 7: drops happen) and at decode, S = 1 (capacity 1).  Then 4 layers at
    full width: prefill 2 x 96 tokens and 8 greedy decode steps, card
    against CPU, tokens equal under the margin rule."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, transformer
    from repro_torch.pytree import tree_map

    cfg = get_arch("qwen3-moe-30b-a3b")
    if {k: getattr(cfg, k) for k in QWEN_DIMS} != QWEN_DIMS:
        raise AssertionError("not qwen3-moe-30b-a3b at full width")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    p = moe.init_moe(gen, cfg)
    p_cpu = tree_map(lambda a: a.cpu(), p)
    rows = []
    for s in (MOE_PREFILL, 1):
        x = torch.from_numpy(np.random.default_rng(s).standard_normal(
            (2, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        y, ix, probs = moe.moe_block(p, x.cuda(), cfg, return_routing=True)
        yc, ixc, probsc = moe.moe_block(p_cpu, x, cfg, return_routing=True)
        ix, ixc = ix.cpu().numpy(), ixc.numpy()
        probsc = probsc.numpy()
        decided, ordered, clean = routing_masks(np, probsc, cfg.top_k, ixc)
        if not ((np.sort(ix, -1) == np.sort(ixc, -1)).all(-1)[decided].all()
                and (ix == ixc).all(-1)[ordered].all()):
            raise AssertionError(f"S={s}: the card routes decided tokens "
                                 "to other experts than the CPU")
        a, b = y.float().cpu().numpy(), yc.float().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"S={s}: non-finite MoE output")
        diff = np.abs(a - b)
        outside = float((diff > ATOL + RTOL * np.abs(b))[clean].mean())
        c = moe.capacity(cfg, s)
        drops = int(sum(max(int(n) - c, 0) for g in ixc for n in np.bincount(
            g.ravel(), minlength=cfg.n_experts)))
        if outside > MOE_MAX_OUTSIDE or diff[clean].max() > MOE_MAX_ABS or \
                clean.mean() < 0.9:
            raise AssertionError(f"S={s}: card vs CPU MoE outputs: max "
                                 f"|diff| {diff[clean].max()}, "
                                 f"{outside} outside")
        if (drops > 0) != (s == MOE_PREFILL):
            raise AssertionError(f"S={s}: {drops} entries dropped")
        xc = x.cuda()
        ms = host_ms(torch, lambda: moe.moe_block(p, xc, cfg), 10)
        rows.append({"tokens_per_group": s, "capacity": c, "drops": drops,
                     "undecided_tokens": int((~decided).sum()),
                     "compared_tokens": int(clean.sum()),
                     "max_abs_diff": float(diff[clean].max()),
                     "outside_tol": outside, "block_ms": ms})
        log(f"MoE block at full width, S={s} (capacity {c}, {drops} "
            f"entries dropped): card vs CPU max |diff| "
            f"{rows[-1]['max_abs_diff']:.6f}, {outside:.6f} outside, over "
            f"{int(clean.sum())} tokens ({int((~decided).sum())} near "
            f"ties), {ms:.4f} ms")
    del p, p_cpu

    cfg4 = dataclasses.replace(cfg, n_layers=MOE_LAYERS)
    params = transformer.init_params(cfg4, seed=1, device="cuda")
    params_cpu = tree_map(lambda a: a.cpu(), params)
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size,
                                             (2, MOE_PREFILL))
    max_seq = MOE_PREFILL + MOE_DECODE

    def routed(fn):
        """``fn()`` and every MoE block's (B, S, K) expert sets."""
        rec, real = [], moe.moe_block

        def spy(p, x, c, return_routing=False):
            y, ix, probs = real(p, x, c, return_routing=True)
            rec.append(ix.sort(-1).values.cpu().numpy())
            return (y, ix, probs) if return_routing else y

        moe.moe_block = spy
        try:
            return fn(), rec
        finally:
            moe.moe_block = real

    def same_rows(ra, rb):
        """Rows whose every token took the same experts in every layer."""
        return np.all([(a == b).all(axis=(1, 2)) for a, b in zip(ra, rb)],
                      axis=0)

    (lg, cache), rg = routed(lambda: transformer.prefill(
        params, cfg4, {"tokens": toks}, max_seq))
    (lc, cache_c), rc = routed(lambda: transformer.prefill(
        params_cpu, cfg4, {"tokens": toks}, max_seq))
    flips = [int((~(a == b).all(-1)).sum()) for a, b in zip(rg, rc)]
    same = same_rows(rg, rc)
    compared, decode_pairs, d_max, agree = 0, 0, 0.0, []
    for t in range(MOE_DECODE):
        a, b = lg.float().cpu().numpy(), lc.numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite logits at step {t}")
        gap = top2_gap(np, b)
        for r in np.nonzero(same)[0]:
            compared += 1
            decode_pairs += t > 0
            d_max = max(d_max, float(np.abs(a[r] - b[r]).max()))
            agree.append(a[r].argmax() == b[r].argmax())
            if not agree[-1] and gap[r] > 0.1:
                raise AssertionError(
                    f"{MOE_LAYERS} MoE layers, step {t}, row {r}: the card's "
                    "greedy token differs from the CPU's, routed alike, "
                    f"where the top-1/top-2 gap is {gap[r]}")
        nxt = b.argmax(-1)[:, None]               # the CPU's token to both
        (lg, cache), rg = routed(lambda: transformer.decode_step(
            params, cfg4, nxt, cache, MOE_PREFILL + t))
        (lc, cache_c), rc = routed(lambda: transformer.decode_step(
            params_cpu, cfg4, nxt, cache_c, MOE_PREFILL + t))
        same = same_rows(rg, rc)
    if decode_pairs < (MOE_DECODE - 1):
        raise AssertionError(f"only {decode_pairs} of {2 * (MOE_DECODE - 1)} "
                             "decode steps routed alike on card and CPU")
    log(f"{MOE_LAYERS} MoE layers at full width, prefill {MOE_PREFILL} + "
        f"{MOE_DECODE} decode steps: prefill tokens routed differently per "
        f"layer {flips} of {2 * MOE_PREFILL}; {compared} of "
        f"{2 * MOE_DECODE} (row, step) logits routed alike, max |diff| "
        f"{d_max:.6f}, greedy tokens agree {float(np.mean(agree)):.3f}")
    del params, params_cpu, cache, cache_c
    return {"block": rows, "layers": MOE_LAYERS,
            "prefill_routing_flips": flips, "compared_steps": compared,
            "logits_max_abs_diff": d_max,
            "greedy_agree": float(np.mean(agree))}


def qwen_tree(params) -> None:
    b0 = params["groups"]["b0"]
    if sorted(params["groups"]) != ["b0"] or "mlp" in b0 or \
            tuple(b0["moe"]["w_up"].shape) != (48, 128, 2048, 768):
        raise AssertionError("qwen3-moe's tree is not 48 x b0 with moe")


def moe_phase(np, torch, smi: str, base_bytes: int) -> dict:
    """Phase 3c: free the card of gemma3-27b, then (a) the shards on the
    card, (b) the MoE block and 4 MoE layers card vs CPU, and (c)
    qwen3-moe-30b-a3b at full width and depth behind the edge with
    ``--n-shards 4``."""
    left = free_card(torch)
    log(f"phase 3c: {left / 1e9:.4f} GB allocated after phase 3b "
        f"(before phase 3: {base_bytes / 1e9:.4f} GB)")
    if left > base_bytes + (64 << 20):
        raise AssertionError(f"phase 3b left {left - base_bytes} bytes on "
                             "the card")
    t0 = time.perf_counter()
    zero_counts()
    shards = shard_check(np, torch)
    counted = read_counts()["xam_search_multiset"]
    # the CPU index's lookups run the plain version, which counts too;
    # the timed lookups after the schedule are not the path's
    if counted != (shards["launches"] + shards["cpu_plain_runs"]
                   + shards["timing_launches"]):
        raise AssertionError(f"multi-set count {counted} != {shards}")
    layer = moe_layer_check(np, torch)
    free_card(torch)
    edge = edge_phase(np, torch, smi, MOE_EDGE_ARGV, QWEN_DIMS, qwen_tree)
    free_card(torch)
    log(f"phase 3c: {time.perf_counter() - t0:.1f} s")
    return {"shards": shards, "moe": layer, "edge": edge,
            "allocated_after_phase3b_bytes": left}


# ---------------------------------------------------------------------------
# Phase 1: build every kernel library, all nvcc runs started together.
# ---------------------------------------------------------------------------

KERNEL_MODULES = {
    "xam_search_multiset": "repro_torch.kernels.xam_search.kernel:library",
    "xam_search": "repro_torch.kernels.xam_search.kernel:flat_library",
    "hopscotch_lookup": "repro_torch.kernels.hopscotch.kernel:library",
    "string_match": "repro_torch.kernels.string_match.kernel:library",
}


def build_all() -> dict:
    import concurrent.futures
    import importlib

    def one(spec):
        mod, fn = spec.split(":")
        return getattr(importlib.import_module(mod), fn)()

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_MODULES)) as ex:
        libs = dict(zip(KERNEL_MODULES,
                        ex.map(one, KERNEL_MODULES.values())))
    wall = time.perf_counter() - t0
    out = {}
    for name, lib in libs.items():
        log(f"kernel library {lib.path.relative_to(ROOT)} built in "
            f"{lib.build_seconds:.2f} s")
        for line in lib.ptxas_lines():
            log(f"ptxas ({name}): {line}")
        out[name] = {"build_s": lib.build_seconds,
                     "ptxas": lib.ptxas_lines()}
    log(f"phase 1: four libraries built in {wall:.2f} s wall")
    return out


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.xam_search import ops as xam
    xam.LAUNCH_COUNT = xam.ADMIT_LAUNCH_COUNT = xam.FLAT_LAUNCH_COUNT = 0
    hop.LAUNCH_COUNT = sm.LAUNCH_COUNT = 0


def read_counts() -> dict:
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.xam_search import ops as xam
    return {"xam_search_multiset": xam.LAUNCH_COUNT,
            "xam_search": xam.FLAT_LAUNCH_COUNT,
            "hopscotch_lookup": hop.LAUNCH_COUNT,
            "string_match": sm.LAUNCH_COUNT}


def timed_row(timer, name, kern, plain, n_bytes, n_ops, reps,
              plain_reps=None, **extra):
    """Kernel and plain version timed as phase 2 times them, beside the
    bound (the larger of bytes / HBM rate and operations / int8 rate).
    With ``plain_reps`` (a plain version of thousands of launches) the
    plain version is timed by CUDA events over that many calls only, and
    its ``plain_ms`` is that per-call time."""
    call_ms = timer.call_ms(kern)
    ms = timer.graph_ms(kern, reps=reps)
    if plain_reps:
        plain_call_ms = timer.call_ms(plain, reps=plain_reps, warmup=1)
        plain_ms = plain_call_ms
    else:
        plain_call_ms = timer.call_ms(plain)
        plain_ms = timer.graph_ms(plain, reps=reps)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    row = {"shape": name, **extra, "ms": ms, "plain_ms": plain_ms,
           "call_ms": call_ms, "plain_call_ms": plain_call_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": int(n_bytes)}
    log(f"time {name}: kernel {ms:.6f} ms (per call with host "
        f"{call_ms:.6f}), plain {plain_ms:.6f} ms ({plain_call_ms:.6f}), "
        f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}, {n_bytes} B)")
    return row


def assert_equal(torch, got, want, what: str) -> int:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (int((got.long() - want.long()).abs().max())
                if got.shape == want.shape else -1)
        raise AssertionError(f"kernel != plain: {what} (max diff {diff})")
    return 0


def flat_edge_cases(np, torch) -> int:
    """The flat search against its plain version at the edges of its
    design: R at every word-count template's edge, C = 1, 3, 513 and 1000
    (the 4-column vectors' tails), Q = 1, 63, 65 and 130 (the staged query
    chunks), all-zero and partial masks, int8 and packed8 planes, and a
    plane view at an odd address.  Returns the number of cases."""
    from repro_torch.kernels.xam_search import ops as xam
    from repro_torch.kernels.xam_search.ref import xam_search_plain

    rng = np.random.default_rng(11)
    n_cases = 0
    for r in (1, 31, 32, 33, 64, 65, 511, 512):
        for c in (1, 3, 513, 1000):
            for q in (1, 63, 65, 130):
                keys = rng.integers(0, 2, (q, r)).astype(np.int8)
                data = rng.integers(0, 2, (r, c)).astype(np.int8)
                masks = (rng.random((q, r)) < 0.95).astype(np.int8)
                masks[1::4] = 0
                masks[2::4, : (r + 1) // 2] = 0
                for i in range(0, q, 3):
                    data[:, (7 * i) % c] = keys[i]
                k, m, d = (torch.from_numpy(x).cuda()
                           for x in (keys, masks, data))
                for packed in (False, True):
                    dd = xam.pack_rows(d) if packed else d
                    assert_equal(torch, xam.xam_search_device(k, dd, m),
                                 xam_search_plain(k, dd, m),
                                 f"flat search q={q} r={r} c={c} "
                                 f"packed={packed}")
                    n_cases += 1
    for packed in (False, True):
        d = torch.from_numpy(rng.integers(0, 2, (64, 512)).astype(np.int8)
                             ).cuda()
        d = xam.pack_rows(d) if packed else d
        store = torch.empty(d.numel() + 1, dtype=d.dtype, device="cuda")
        view = store[1:].view(d.shape)
        view.copy_(d)
        k = torch.from_numpy(rng.integers(0, 2, (70, 64)).astype(np.int8)
                             ).cuda()
        m = torch.ones_like(k)
        k[5] = 0
        assert_equal(torch, xam.xam_search_device(k, view, m),
                     xam_search_plain(k, d, m),
                     f"flat search, unaligned plane view packed={packed}")
        n_cases += 1
    return n_cases


def string_edge_cases(np, torch) -> int:
    """The string match against its plain version at the edges of its
    design: text views at byte offsets 0, 1, 3 and 15, N = 2 x 16 KiB + 37
    (not a multiple of 16), P = 0, 1, 3, 4, 5, 15, 16, 17, 4095 and 4096,
    matches planted across a 16-byte group, the first tile edge and at the
    end; P > N; one repeated byte.  Returns the number of cases."""
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.string_match.ref import string_match_plain

    rng = np.random.default_rng(12)
    n = 2 * 16384 + 37
    n_cases = 0
    for p in (0, 1, 3, 4, 5, 15, 16, 17, 4095, 4096):
        for offset in (0, 1, 3, 15):
            text = rng.integers(97, 99, n + offset).astype(np.uint8)
            pat = rng.integers(97, 99, p).astype(np.uint8)
            for start in (16 * 5 + 13, 16384 - p // 2, n - p):
                if 0 <= start <= n - p:
                    text[offset + start:offset + start + p] = pat
            tt = torch.from_numpy(text).cuda()[offset:]
            pt = torch.from_numpy(pat).cuda()
            got = sm.string_match(tt, pt)
            assert_equal(torch, got, string_match_plain(tt, pt),
                         f"string match P={p} offset={offset}")
            if p and int(got[n - p]) != 1:
                raise AssertionError("a planted match at the end was lost")
            n_cases += 1
    same = torch.full((n,), 97, dtype=torch.uint8, device="cuda")[1:]
    for text_t, p in [(same, 1), (same, 4), (same, 5), (same, 64),
                      (same, 4096), (same[:37], 38), (same[:5], 4096)]:
        pt = torch.full((p,), 97, dtype=torch.uint8, device="cuda")
        got = sm.string_match(text_t, pt)
        assert_equal(torch, got, string_match_plain(text_t, pt),
                     f"string match, repeated byte, N={text_t.shape[0]} "
                     f"P={p}")
        if int(got.sum()) != max(text_t.shape[0] - p + 1, 0):
            raise AssertionError("repeated byte: a match was lost")
        n_cases += 1
    return n_cases


# ---------------------------------------------------------------------------
# Phase 4: the slice-2 kernels against their plain versions, then timed.
# ---------------------------------------------------------------------------

HOP_SIZES = [("path table, 2^17 slots", 17, 8192),
             ("paper's largest table, 2^25 slots", 25, 1 << 20)]
CORPUS_BYTES = 500 * 2 ** 20        # benchmarks/string_match.py WORKING_SET
DEDUP = (4096, 32, 65536)           # fingerprints x bits x columns
FIG6 = (1, 64, 512)                 # one key against one Monarch set


def hop_case(torch, log2_n, window, n_q, seed):
    """Synthetic key planes of 2^log2_n + 2H slots made on the card, queries
    with homes in [0, n) and a planted hit for every other query."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 << log2_n
    slots = n + 2 * window
    rnd = lambda size, lo, hi: torch.randint(lo, hi, size, generator=g,
                                             device="cuda", dtype=torch.int32)
    t_lo, t_hi = rnd((slots,), -2 ** 31, 2 ** 31), rnd((slots,), -2 ** 31,
                                                      2 ** 31)
    homes = rnd((n_q,), 0, n)
    q_lo, q_hi = rnd((n_q,), -2 ** 31, 2 ** 31), rnd((n_q,), -2 ** 31,
                                                    2 ** 31)
    at = (homes + rnd((n_q,), 0, window)).long()
    q_lo[::2], q_hi[::2] = t_lo[at[::2]], t_hi[at[::2]]
    return t_lo, t_hi, homes, q_lo, q_hi


def hop_bytes(torch, ops_, want, window) -> tuple[int, int, int]:
    """What one lookup batch needs, from its data: ``(bytes, sectors,
    compares)``.  The function reads t_lo over each query's window up to the first hit
    (the whole window for a miss), clipped to the table, and t_hi only
    where t_lo equals the query's low half; each slot once, however many
    windows share it; 16 bytes per query (home, key halves, result).
    ``sectors`` counts the distinct 32-byte sectors those reads touch, the
    granule in which DRAM serves scattered windows; ``compares`` one per
    word each query reads."""
    t_lo, _, homes, q_lo, _ = ops_
    n = t_lo.shape[0]
    h = homes.long()
    touched = torch.where(want >= 0, want + 1, window).long()
    off = torch.arange(window, device=h.device)
    idx = h[:, None] + off
    need = (off < touched[:, None]) & (idx >= 0) & (idx < n)
    lo_hit = need & (t_lo[idx.clamp(0, n - 1)] == q_lo[:, None])

    def distinct(slots, per):           # slots, or sectors of `per` slots
        seen = torch.zeros(n // per + 1, dtype=torch.bool, device=h.device)
        seen[slots // per] = True
        return int(seen.sum())
    lo, hi = idx[need], idx[lo_hit]
    q = 16 * homes.shape[0]
    return (4 * (distinct(lo, 1) + distinct(hi, 1)) + q,
            32 * (distinct(lo, 8) + distinct(hi, 8)) + q,
            lo.numel() + hi.numel())


def hop_edge_cases(torch) -> int:
    """The hopscotch lookup against its plain version at the edges of its
    design: H = 1, 4, 33, 128 and 256 (lane groups of 1, 4 and 8; one to
    eight steps), a first hit at every offset of a window, windows below 0
    and past N.  Returns the number of cases."""
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain

    from repro_torch.kernels.edge_cases import hop_edge_case
    for window in (1, 4, 33, 128, 256):
        ops_ = [torch.from_numpy(x).cuda()
                for x in hop_edge_case(window, window)]
        got = hop.hopscotch_lookup_device(*ops_, window=window)
        assert_equal(torch, got, hopscotch_lookup_plain(*ops_, window),
                     f"hopscotch edges H={window}")
        if got[:window].tolist() != list(range(window)):
            raise AssertionError("a planted hopscotch first hit was missed")
    return 5


def kernels_phase(np, torch, timer, corpus_t) -> dict:
    """Exact equality of each new kernel with its plain version at the
    path's shapes and the edge cases, then the timings.  Returns
    {kernel: {"max_abs_err", "shapes"}}."""
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.string_match.ref import string_match_plain
    from repro_torch.kernels.xam_search import kernel as xam_kernel
    from repro_torch.kernels.xam_search import ops as xam
    from repro_torch.kernels.xam_search.ref import xam_search_plain

    t0 = time.perf_counter()
    out = {}
    # Hopscotch lookup: H in {4, 32, 128} at both table sizes.
    rows, n_cases = [], 0
    for name, log2_n, n_q in HOP_SIZES:
        for window in (4, 32, 128):
            ops_ = hop_case(torch, log2_n, window, n_q, seed=window + log2_n)
            got = hop.hopscotch_lookup_device(*ops_, window=window)
            want = hopscotch_lookup_plain(*ops_, window)
            assert_equal(torch, got, want, f"hopscotch {name} H={window}")
            if not bool((want[::2] >= 0).all()):
                raise AssertionError("a planted hopscotch hit was missed")
            n_cases += 1
            n_bytes, sector_bytes, n_ops = hop_bytes(torch, ops_, want,
                                                     window)
            rows.append(timed_row(
                timer, f"hopscotch {name}, H={window}, Q={n_q}",
                lambda: hop.hopscotch_lookup_device(*ops_, window=window),
                lambda: hopscotch_lookup_plain(*ops_, window),
                n_bytes, n_ops,
                reps=5 if n_q > 8192 else 20,
                log2_slots=log2_n, window=window, queries=n_q,
                sector_bound_ms=sector_bytes / HBM_BYTES_PER_S * 1e3))
            del ops_
    n_cases += hop_edge_cases(torch)
    log(f"hopscotch kernel == plain version on {n_cases} cases (H = 1..256, "
        "a first hit at every offset, windows below 0 and past N)")
    out["hopscotch_lookup"] = {"max_abs_err": 0.0, "shapes": rows}

    # String match: edge cases, then the 500 MiB corpus with P = 12.
    rng = np.random.default_rng(3)
    edge = [(1, 1), (4096, 1), (4096 * 3 + 7, 3), (20000, 4096), (10, 11),
            (4096 * 2 + 5, 12)]
    for n, p in edge:
        text = rng.integers(97, 99, n).astype(np.uint8)
        pat = rng.integers(97, 99, p).astype(np.uint8)
        if p <= n:
            s = max(0, min(4096 - p // 2, n - p))
            text[s:s + p] = pat
        tt, pt = torch.from_numpy(text).cuda(), torch.from_numpy(pat).cuda()
        assert_equal(torch, sm.string_match(tt, pt),
                     string_match_plain(tt, pt), f"string match N={n} P={p}")
    n = corpus_t.shape[0]
    at = n // 4 + 1
    pat_t = corpus_t[at:at + 12].clone()
    got = sm.string_match(corpus_t, pat_t)
    assert_equal(torch, got, string_match_plain(corpus_t, pat_t),
                 "string match, 500 MiB corpus, P=12")
    if int(got[at]) != 1:
        raise AssertionError("the 500 MiB corpus lost its own pattern")
    n_edge = string_edge_cases(np, torch)
    log(f"string-match kernel == plain version on {len(edge) + 1 + n_edge} "
        "cases (P = 0..4096 around the prefix filter and the 16-position "
        "groups, text views at byte offsets 1, 3 and 15, P > N, matches "
        "across groups and tiles, one repeated byte)")
    rows = [timed_row(
        timer, "string match, 500 MiB corpus, P=12",
        lambda: sm.string_match(corpus_t, pat_t),
        lambda: string_match_plain(corpus_t, pat_t), 2 * n + 12, n, reps=5,
        text_bytes=n, pattern_len=12)]
    # P = 1 and P = 4096 on the corpus; one repeated byte with P = 64, where
    # every position compares the whole pattern (the worst case).
    same_t = torch.full((n,), 97, dtype=torch.uint8, device="cuda")
    for name, text_t, p in [("P=1", corpus_t, 1), ("P=4096", corpus_t, 4096),
                            ("one repeated byte, P=64", same_t, 64)]:
        pt = text_t[at:at + p].clone()
        want = string_match_plain(text_t, pt)
        assert_equal(torch, sm.string_match(text_t, pt), want,
                     f"string match, 500 MiB, {name}")
        n_ops = int(want.sum()) * p if text_t is same_t else n
        rows.append(timed_row(
            timer, f"string match, 500 MiB, {name}",
            lambda: sm.string_match(text_t, pt),
            lambda: string_match_plain(text_t, pt), 2 * n + p, n_ops,
            reps=5, plain_reps=2 if p > 64 else None, text_bytes=n,
            pattern_len=p))
        del want
    del same_t
    out["string_match"] = {"max_abs_err": 0.0, "shapes": rows}

    # Flat search: Fig. 6 and dedup shapes, int8 and packed8 planes.
    rows = []
    for name, (q, r, c) in [("Fig. 6, one key x one set", FIG6),
                            ("dedup, 4096 fingerprints x 65536 columns",
                             DEDUP),
                            ("ragged", (130, 33, 1000))]:
        keys = rng.integers(0, 2, (q, r)).astype(np.int8)
        data = rng.integers(0, 2, (r, c)).astype(np.int8)
        masks = np.ones((q, r), np.int8)
        masks[1::7] = 0                          # all-masked rows
        masks[2::7, : r // 2] = 0                # partial masks
        data[:, c // 3] = keys[0]
        k, m, d = (torch.from_numpy(x).cuda() for x in (keys, masks, data))
        for packed in (False, True):
            dd = xam.pack_rows(d) if packed else d
            got = xam.xam_search_device(k, dd, m)
            assert_equal(torch, got, xam_search_plain(k, dd, m),
                         f"flat search {name} packed={packed}")
            if int(got[0, c // 3]) != 1:
                raise AssertionError("a planted flat-search hit was missed")
            if name == "ragged":
                continue
            n_bytes = 2 * q * r + dd.numel() + q * c
            warm = {}
            if q == 1:           # launch floor vs cold-memory round trip
                warm["warm_ms"] = timer.graph_ms(
                    lambda: xam.xam_search_device(k, dd, m), reps=100,
                    flush=False)
            rows.append(timed_row(
                timer, f"flat search {name} "
                f"({'packed8' if packed else 'int8'})",
                lambda: xam.xam_search_device(k, dd, m),
                lambda: xam_search_plain(k, dd, m), n_bytes, q * r * c,
                reps=5 if q * c > 1 << 20 else 100, queries=q, key_bits=r,
                columns=c, plane_format="packed8" if packed else "int8",
                **warm))
    n_edge = flat_edge_cases(np, torch)
    log(f"flat-search kernel == plain version on {6 + n_edge} cases "
        "(int8/packed8, all-masked and partial masks, R at every word "
        "template's edge, ragged C and Q, an unaligned plane view)")
    # The launch floor: one empty block, timed as the kernels are (100 reps:
    # a µs kernel beside 100 L2 flushes).  The Fig. 6 search is held to
    # 1.5x of it.
    floor_ms = timer.graph_ms(xam_kernel.empty_kernel_cuda, reps=100)
    rows.append({"shape": "empty kernel (launch floor)", "ms": floor_ms,
                 "warm_ms": timer.graph_ms(xam_kernel.empty_kernel_cuda,
                                           reps=100, flush=False),
                 "call_ms": timer.call_ms(xam_kernel.empty_kernel_cuda)})
    ratio = rows[0]["ms"] / floor_ms if floor_ms > 0 else float("inf")
    log(f"time empty kernel: {floor_ms:.6f} ms (warm L2 "
        f"{rows[-1]['warm_ms']:.6f}); Fig. 6 int8 search "
        f"{rows[0]['ms']:.6f} ms = {ratio:.3f} x the floor (warm L2 "
        f"{rows[0]['warm_ms']:.6f} ms)")
    out["xam_search"] = {"max_abs_err": 0.0, "shapes": rows,
                         "floor_ms": floor_ms, "fig6_over_floor": ratio}
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 5: the hash table path.
# ---------------------------------------------------------------------------

FILL_LOG2 = 17          # the paper's smallest table (§10.4: 2^17..2^25)
FILL_WINDOW = 32
FILL_DENSITY = 0.7
FILL_BUDGET_S = 180.0   # past this, the point is cut to 2^16 slots
YCSB_OPS = 8192


def backends_agree(np, torch) -> dict:
    """(a) The host and device backends, on the card, through one 2,000-op
    insert/delete/lookup schedule with wear tracking: bit-identical."""
    from repro_torch.apps.hashtable import HopscotchTable
    from repro_torch.core import wear

    wc = wear.WearConfig(n_supersets=8, t_mww_cycles=64,
                         blocks_per_superset=4)
    # H=4 so that the schedule's inserts run hop chains on the card.
    host, dev = (HopscotchTable(12, window=4, wear_cfg=wc, backend=b)
                 for b in ("host", "device"))
    rng = np.random.default_rng(0)
    universe = np.unique(rng.integers(1, 1 << 40, 3100,
                                      dtype=np.uint64))[:3000]
    live: list[int] = []
    t0 = time.perf_counter()
    for _ in range(2000):
        op = rng.random()
        if op < 0.75 or not live:
            k, v = int(universe[rng.integers(0, 3000)]), int(
                rng.integers(1, 1 << 63))
            if host.insert(k, v) != dev.insert(k, v):
                raise AssertionError("insert results differ")
            live.append(k)
        elif op < 0.85:
            k = live.pop(int(rng.integers(0, len(live))))
            if host.delete(k) != dev.delete(k):
                raise AssertionError("delete results differ")
        else:
            q = rng.choice(universe, 64)
            (vh, hh), (vd, hd) = host.lookup_monarch(q), dev.lookup_monarch(q)
            if not (np.array_equal(vh, vd) and np.array_equal(hh, hd)):
                raise AssertionError("lookups differ")
    dev._sync_host()
    same = (np.array_equal(host.keys, dev.keys)
            and np.array_equal(host.vals, dev.vals)
            and dataclasses.astuple(host.stats) == dataclasses.astuple(
                dev.stats)
            and host.wear_report() == dev.wear_report())
    if not same or not dev._pk_lo.is_cuda:
        raise AssertionError("host and device backends diverged on the card")
    if host.stats.swaps == 0:
        raise AssertionError("the schedule ran no hop chain")
    seconds = time.perf_counter() - t0
    log(f"hash table backends bit-identical after 2000 ops on the card "
        f"({seconds:.1f} s): stats {dataclasses.asdict(host.stats)}, wear "
        f"{host.wear_report()}")
    return {"seconds": seconds, "stats": dataclasses.asdict(host.stats),
            "wear": host.wear_report()}


def hashtable_point(np, torch, log2_size: int) -> dict:
    """(b) One Fig. 12-14 point (benchmarks/fig12_14_hashing.py run_point's
    sizes): fill to density 0.7 in random order, then 8,192 YCSB ops
    (zipf 1.2, 95% reads), the reads in one lookup_monarch batch and the
    writes as inserts of fresh keys.  Returns the times and the launch
    counts of the path, read just after it."""
    import collections
    from repro_torch.apps.hashtable import HopscotchTable
    from repro_torch.data.pipeline import murmur3_np

    table = HopscotchTable(log2_size, window=FILL_WINDOW, backend="device")
    calls = collections.Counter()
    inner = table._lookup_window

    def counted(keys):
        calls["lookup_window"] += 1
        return inner(keys)
    table._lookup_window = counted

    n_fill = int(table.n * FILL_DENSITY)
    rng = np.random.default_rng(0)
    ids = np.arange(1, n_fill + 1, dtype=np.uint32)
    fill_keys = (murmur3_np(ids).astype(np.uint64) << np.uint64(13)) | \
        ids.astype(np.uint64)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in rng.permutation(fill_keys):
        table.insert(int(k), int(k) ^ 0xABCD)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    ranks = rng.zipf(1.2, YCSB_OPS) % n_fill
    is_read = rng.random(YCSB_OPS) < 0.95
    r_keys = fill_keys[ranks][is_read]
    t0 = time.perf_counter()
    vals, hits = table.lookup_monarch(r_keys)
    torch.cuda.synchronize()
    lookup_ms = (time.perf_counter() - t0) * 1e3
    w_ids = rng.integers(n_fill + 1, n_fill * 2, int((~is_read).sum())
                         ).astype(np.uint64)
    w_keys = (murmur3_np(w_ids.astype(np.uint32)).astype(np.uint64)
              << np.uint64(13)) | w_ids
    t0 = time.perf_counter()
    for k in w_keys:
        table.insert(int(k), 1)
    torch.cuda.synchronize()
    write_ms = (time.perf_counter() - t0) * 1e3 / max(len(w_keys), 1)
    all_vals, all_hits = table.lookup_monarch(fill_keys)
    counts = read_counts()
    if not (hits.all() and np.array_equal(vals, r_keys ^ np.uint64(0xABCD))):
        raise AssertionError("a YCSB read missed or returned a wrong value")
    if not (all_hits.all()
            and np.array_equal(all_vals, fill_keys ^ np.uint64(0xABCD))):
        raise AssertionError("a filled key was lost or its value changed")
    if counts["hopscotch_lookup"] != calls["lookup_window"] or \
            counts["hopscotch_lookup"] == 0:
        raise AssertionError(f"{counts['hopscotch_lookup']} lookup launches "
                             f"for {calls['lookup_window']} window lookups")
    # The kernel's share of one lookup batch: its device time at this
    # batch's shape against the host-clock batch time.
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.hopscotch.ops import as_i32_bits
    qp = 1 << max(3, (len(r_keys) - 1).bit_length())
    qv = torch.zeros((3, qp), dtype=torch.int32, device="cuda")
    qv[0, :len(r_keys)] = torch.from_numpy(table.home(r_keys).astype(
        np.int32)).cuda()
    qv[1, :len(r_keys)] = torch.from_numpy(as_i32_bits(
        r_keys & np.uint64(0xFFFFFFFF))).cuda()
    qv[2, :len(r_keys)] = torch.from_numpy(as_i32_bits(
        r_keys >> np.uint64(32))).cuda()
    timer = CudaTimer(torch)
    kern_ms = timer.graph_ms(lambda: hop.hopscotch_lookup_device(
        table._pk_lo, table._pk_hi, qv[0], qv[1], qv[2],
        window=FILL_WINDOW))
    res = {"log2_size": log2_size, "window": FILL_WINDOW,
           "inserts": int(n_fill), "fill_s": fill_s,
           "fill_ms_per_insert": fill_s * 1e3 / n_fill,
           "reads": int(len(r_keys)), "lookup_batch_ms": lookup_ms,
           "lookup_kernel_ms": kern_ms,
           "kernel_share": kern_ms / lookup_ms,
           "writes": int(len(w_keys)), "write_ms_per_insert": write_ms,
           "load": table.load, "stats": dataclasses.asdict(table.stats),
           "launches": counts}
    log(f"hash table 2^{log2_size} slots, H={FILL_WINDOW}: filled "
        f"{n_fill} keys in {fill_s:.1f} s ({res['fill_ms_per_insert']:.4f} "
        f"ms per insert); {len(r_keys)} YCSB reads in one batch "
        f"{lookup_ms:.4f} ms (kernel {kern_ms:.6f} ms, share "
        f"{res['kernel_share']:.4f}); {len(w_keys)} writes "
        f"{write_ms:.4f} ms each; every key found; launches {counts} == "
        f"{calls['lookup_window']} window lookups")
    return res


def hashtable_phase(np, torch) -> dict:
    t0 = time.perf_counter()
    agree = backends_agree(np, torch)
    point = hashtable_point(np, torch, FILL_LOG2)
    if point["fill_s"] > FILL_BUDGET_S:
        log(f"fill of 2^{FILL_LOG2} slots took {point['fill_s']:.1f} s > "
            f"{FILL_BUDGET_S} s: the point is cut to 2^16 slots")
        point = hashtable_point(np, torch, 16)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    return {"backends": agree, "point": point}


# ---------------------------------------------------------------------------
# Phase 6: string match and the flat-CAM API.
# ---------------------------------------------------------------------------

def stringmatch_phase(np, torch, corpus_t) -> dict:
    """32 patterns of 12 bytes at seeded offsets of the 500 MiB corpus,
    each through ``stringmatch.find`` (one launch) and held to the plain
    version's count on the card."""
    from repro_torch.apps import stringmatch
    from repro_torch.kernels.string_match.ref import string_match_plain

    offs = np.random.default_rng(6).integers(0, corpus_t.shape[0] - 12, 32)
    pats = [bytes(corpus_t[o:o + 12].cpu().numpy()) for o in offs]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = [stringmatch.find(corpus_t, p) for p in pats]
    seconds = time.perf_counter() - t0
    counts = read_counts()
    for p, rep in zip(pats, reports):
        pt = torch.frombuffer(bytearray(p), dtype=torch.uint8).cuda()
        want = int(string_match_plain(corpus_t, pt).sum())
        if rep.n_matches != want or rep.n_matches < 1:
            raise AssertionError(f"find({p!r}): {rep.n_matches} matches, "
                                 f"plain version {want}")
    if counts["string_match"] != len(pats):
        raise AssertionError(f"{counts['string_match']} string-match "
                             f"launches for {len(pats)} finds")
    log(f"stringmatch.find: 32 patterns of 12 bytes over 500 MiB in "
        f"{seconds:.3f} s ({seconds * 1e3 / 32:.4f} ms per find), matches "
        f"{[r.n_matches for r in reports[:8]]}..., all == plain version; "
        f"launches {counts['string_match']}")
    return {"seconds": seconds, "ms_per_find": seconds * 1e3 / 32,
            "matches": [r.n_matches for r in reports],
            "launches": counts, "find_breakdown": find_breakdown(
                np, torch, corpus_t, pats[0])}


def added_peak_bytes(torch, fn) -> int:
    """Device memory that ``fn`` allocates at its peak beyond what was
    allocated before it (after a synchronisation)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def find_breakdown(np, torch, corpus_t, pattern: bytes) -> dict:
    """One ``find`` taken apart on the host clock (each step ending in a
    synchronisation): pattern upload, kernel, count, read-back, beside the
    whole call; the count's device time, and the peak device memory that a
    ``find`` adds and that each way of counting the (N,) int8 flags adds:
    the port's ``count_flags`` against ``sum(dtype=torch.int64)`` and
    ``torch.count_nonzero``."""
    from repro_torch.apps import stringmatch
    from repro_torch.kernels.string_match import ops as sm

    n = corpus_t.shape[0]
    upload = lambda: torch.frombuffer(bytearray(pattern),
                                      dtype=torch.uint8).cuda()
    pt = upload()
    flags = sm.string_match(corpus_t, pt)
    count = sm.count_flags(flags)
    timer = CudaTimer(torch)
    res = {
        "find_ms": host_ms(torch, lambda: stringmatch.find(corpus_t, pattern),
                           10),
        "upload_ms": host_ms(torch, upload, 10),
        "kernel_ms": host_ms(torch, lambda: sm.string_match(corpus_t, pt),
                             10),
        "count_ms": host_ms(torch, lambda: sm.count_flags(flags), 10),
        "readback_ms": host_ms(torch, lambda: int(count), 10),
        "count_device_ms": timer.graph_ms(lambda: sm.count_flags(flags),
                                          reps=5),
        "sum_int64_ms": host_ms(torch, lambda: flags.sum(dtype=torch.int64),
                                10),
        "sum_int64_device_ms": timer.graph_ms(
            lambda: flags.sum(dtype=torch.int64), reps=5),
        "count_nonzero_ms": host_ms(torch,
                                    lambda: torch.count_nonzero(flags), 10),
        "text_bytes": n,
    }
    del timer
    if int(count) != int(torch.count_nonzero(flags)):
        raise AssertionError("count_flags != count_nonzero")
    for name, fn in [("count", lambda: sm.count_flags(flags)),
                     ("sum_int64", lambda: flags.sum(dtype=torch.int64)),
                     ("count_nonzero", lambda: torch.count_nonzero(flags))]:
        res[f"{name}_added_bytes"] = added_peak_bytes(torch, fn)
    del flags, count
    res["find_added_bytes"] = added_peak_bytes(
        torch, lambda: stringmatch.find(corpus_t, pattern))
    if res["find_added_bytes"] > 2 * n:
        raise AssertionError(f"a find adds {res['find_added_bytes']} bytes "
                             f"of device memory, more than 2 N = {2 * n}")
    log("find broken down (ms, host clock): " + ", ".join(
        f"{k} {v:.4f}" for k, v in res.items() if k.endswith("_ms"))
        + f"; a find adds {res['find_added_bytes'] / n:.4f} N bytes at its "
        f"peak; counting adds {res['count_added_bytes'] / n:.4f} N "
        f"(sum(dtype=int64) {res['sum_int64_added_bytes'] / n:.4f} N, "
        f"count_nonzero {res['count_nonzero_added_bytes'] / n:.4f} N)")
    return res


def monarch_api_phase(np, torch) -> dict:
    """``MonarchDevice()`` at its defaults filled through cam_write and
    ram_write, 256 lookups of stored keys, 64 of absent keys and a masked
    partial search, then ``dedup_mask`` at the dedup shape."""
    from repro_torch.core.api import MonarchDevice
    from repro_torch.data.pipeline import dedup_mask
    from repro_torch.kernels.xam_search import ops as xam

    rng = np.random.default_rng(8)
    t0 = time.perf_counter()
    zero_counts()
    dev = MonarchDevice()
    n = dev.n_sets * dev.set_cols
    keys = np.unique(rng.integers(0, 2 ** 64, n + 64, dtype=np.uint64))
    keys = rng.permutation(keys)[:n]
    vals = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
    k_alloc, d_alloc = dev.flat_cam_malloc(n), dev.flat_ram_malloc(n)
    for i in range(n):
        dev.cam_write(k_alloc, i, int(keys[i]))
        dev.ram_write(d_alloc, i, int(vals[i]))
    fill_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    stored = set(keys.tolist())
    picks = rng.integers(0, n, 256)
    for i in picks:
        if dev.kv_lookup(k_alloc, d_alloc, int(keys[i])) != int(vals[i]):
            raise AssertionError(f"kv_lookup of stored key {i} is wrong")
    absent = [k for k in rng.integers(0, 2 ** 64, 80, dtype=np.uint64)
              .tolist() if k not in stored][:64]
    for k in absent:
        if dev.kv_lookup(k_alloc, d_alloc, k) is not None:
            raise AssertionError("an absent key was found")
    mask = 0xFFFF_FFFF
    probe = int(keys[picks[0]]) ^ (1 << 50)
    first = int(np.argmax((keys & np.uint64(mask)) == np.uint64(probe & mask)))
    if dev.kv_lookup(k_alloc, d_alloc, probe, mask=mask) != int(vals[first]):
        raise AssertionError("masked partial search returned a wrong value")
    lookup_s = time.perf_counter() - t1
    searches = sum(c.startswith("S set=") for c in dev.command_log)
    flat = read_counts()["xam_search"]
    if flat != searches or flat == 0:
        raise AssertionError(f"{flat} flat launches for {searches} "
                             "S commands")
    if not dev.cam_bits.is_cuda:
        raise AssertionError("the CAM planes are off the card")
    # dedup_mask at the dedup shape: a third of the fingerprints stored.
    q, r, c = DEDUP
    fps = rng.integers(0, 2 ** 32, q, dtype=np.uint32)
    words = rng.integers(0, 2 ** 32, c, dtype=np.uint32)
    words[rng.choice(c, q // 3, replace=False)] = fps[: q // 3]
    bits = ((words[None, :] >> np.arange(32, dtype=np.uint32)[:, None]) & 1
            ).astype(np.int8)
    bits_t = torch.from_numpy(bits).cuda()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = dedup_mask(fps, bits_t)
    dedup_first_ms = (time.perf_counter() - t2) * 1e3
    if not np.array_equal(got, np.isin(fps, words)):
        raise AssertionError("dedup_mask disagrees with np.isin")
    counts = read_counts()
    if counts["xam_search"] != searches + 1:
        raise AssertionError("dedup_mask did not run one flat launch")
    dedup_ms = host_ms(torch, lambda: dedup_mask(fps, bits_t), 5)
    log(f"MonarchDevice {dev.n_sets}x{dev.key_bits}x{dev.set_cols}: filled "
        f"{n} keys in {fill_s:.1f} s; 256 stored + {len(absent)} absent "
        f"lookups + 1 masked in {lookup_s:.2f} s, {searches} S commands == "
        f"{flat} flat launches ({lookup_s * 1e3 / searches:.4f} ms per "
        f"command); dedup_mask {q}x{r}x{c} {dedup_ms:.3f} ms (first call "
        f"{dedup_first_ms:.3f} ms, {int(got.sum())} duplicates)")
    return {"fill_s": fill_s, "lookup_s": lookup_s, "searches": searches,
            "ms_per_search_command": lookup_s * 1e3 / searches,
            "dedup_ms": dedup_ms, "dedup_first_ms": dedup_first_ms,
            "launches": counts}


# ---------------------------------------------------------------------------
# Phase 7: the Fig. 9 and Fig. 11 quick sweeps through the batched simulator.
# A short copy of the sweeps' knobs and arithmetic (benchmarks/fig9_cache.py
# sweep_configs and run, benchmarks/fig11_lifetime.py run, at the quick
# sizes of repro/bench/harness.py BenchSizes), held to their committed
# baselines exactly.
# ---------------------------------------------------------------------------
SIM_REQUESTS = 40_000               # BenchSizes(quick=True).fig_requests
SIM_SCALE = 4096                    # 4 GB DRAM -> 4096 blocks (1/16384)
FIG9_SYSTEMS = ["d_cache", "d_cache_ideal", "monarch_unbound", "monarch_m1",
                "monarch_m2", "monarch_m3", "monarch_m4"]
FIG11_S_REAL = 262_144              # 8 GB / (512 blocks x 64 B) supersets
FIG11_EP_IDEAL_YEARS = 16.72
FIG11_RESIDUAL_SKEW = 16.72 / 10.22
EAGER_STEPS = 64                    # the eager window, per family
GRAPH_REPLAYS = 20                  # replays of one captured graph, timed


def fig9_configs(sim) -> dict:
    cfgs = sim.baseline_configs(SIM_SCALE)
    for name in list(cfgs):
        cfgs[name] = dataclasses.replace(cfgs[name], l3_sets=16)
        if cfgs[name].wear_enabled:
            cfgs[name] = dataclasses.replace(
                cfgs[name], t_mww_cycles=(1 << 15) * cfgs[name].m_writes,
                dc_limit=512, window_budget_blocks=64)
    return cfgs


def fig11_config(sim):
    return dataclasses.replace(
        sim.baseline_configs(SIM_SCALE)["monarch_m3"], l3_sets=16,
        t_mww_cycles=(1 << 15) * 3, dc_limit=12, window_budget_blocks=64)


def graph_node_counts(graph) -> dict:
    """Node counts by type of a captured CUDA graph (kept with
    ``keep_graph=True``), read through the driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}
    counts = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        counts[kinds.get(t.value, "other")] += 1
    return counts


def step_profile(torch, sim, shape, fam, trace_list) -> dict:
    """One family's step on the card: µs per step eager (a short window)
    and under CUDA-graph replay, and the captured graph's nodes per step."""
    import numpy as np
    k = sim.GRAPH_STEPS
    cfgs = [cfg for _, cfg in fam for _ in trace_list]
    dyn = sim.dyn_params(cfgs, "cuda")
    wear_on = any(cfg.wear_enabled for _, cfg in fam)
    n = max(EAGER_STEPS, k) + 4
    addrs = torch.from_numpy(np.stack([a[:n] for _, a, _ in trace_list] *
                                      len(fam)).astype(np.int32)).cuda()
    wr = torch.from_numpy(np.stack([w[:n] for _, _, w in trace_list] *
                                   len(fam))).cuda()
    step = sim.make_step(shape, dyn, wear_on)
    st = sim.init_state(shape, "cuda", lanes=len(cfgs))
    for i in range(4):                                   # warm-up
        st, _ = step(st, addrs[:, i], wr[:, i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(4, 4 + EAGER_STEPS):
        st, _ = step(st, addrs[:, i], wr[:, i])
    torch.cuda.synchronize()
    eager_us = (time.perf_counter() - t0) * 1e6 / EAGER_STEPS

    top = torch.full((len(cfgs),), -2 ** 31, dtype=torch.int32, device="cuda")
    a_buf = addrs[:, :k].t().contiguous()
    w_buf = wr[:, :k].t().contiguous()
    t0 = time.perf_counter()
    graph = sim.capture_steps(step, st, top, a_buf, w_buf, keep_graph=True)
    nodes = graph_node_counts(graph)
    graph.instantiate()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    torch.cuda.synchronize()
    graph_us = (time.perf_counter() - t0) * 1e6 / (GRAPH_REPLAYS * k)
    return {"eager_us_per_step": eager_us, "graph_us_per_step": graph_us,
            "capture_s": capture_s,
            "kernels_per_step": nodes["kernel"] / k,
            "graph_nodes": nodes}


def run_families(torch, sim, cfgs: dict, trace_list, *, return_state=False):
    """``simulate_grid`` on the card one shape family at a time, each timed
    (host clock ending in a synchronisation) and profiled."""
    families: dict = {}
    for name, cfg in cfgs.items():
        families.setdefault(sim.shape_of(cfg), []).append((name, cfg))
    results, states, reports = {}, {}, []
    for shape, fam in families.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = sim.simulate_grid(dict(fam), trace_list, device="cuda",
                                return_state=return_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        res, st = out if return_state else (out, {})
        results.update(res)
        states.update(st)
        n_req = len(trace_list[0][1])
        report = {"configs": [name for name, _ in fam],
                  "lanes": len(fam) * len(trace_list), "steps": n_req,
                  "graph_steps": sim.GRAPH_STEPS, "wall_s": wall,
                  "peak_mem_bytes": peak,
                  "us_per_step_in_sweep": wall * 1e6 / n_req,
                  **step_profile(torch, sim, shape, fam, trace_list)}
        log(f"phase 7: family {report['configs']} ({report['lanes']} lanes "
            f"x {n_req} steps) in {wall:.1f} s; "
            f"{report['graph_us_per_step']:.1f} µs/step replayed, "
            f"{report['eager_us_per_step']:.1f} µs/step eager, "
            f"{report['kernels_per_step']:.1f} kernels/step")
        reports.append(report)
    return results, states, reports


def fig9_numbers(res, specs, systems) -> dict:
    """benchmarks/fig9_cache.py run's arithmetic, unchanged."""
    import numpy as np
    speedups = {s: [] for s in systems}
    hitrates = {s: [] for s in systems}
    writes_saved = []
    for spec in specs:
        base = res[("d_cache", spec.name)].total_cycles
        for s in systems:
            r = res[(s, spec.name)]
            speedups[s].append(base / r.total_cycles)
            hitrates[s].append(r.inpkg_hit_rate)
        mu = res[("monarch_unbound", spec.name)].stats
        writes_saved.append(mu["writes_filtered"] / max(mu["l3_evictions"], 1))
    unb = float(np.mean(speedups["monarch_unbound"]))
    ideal = float(np.mean(speedups["d_cache_ideal"]))
    m_means = {m: float(np.mean(speedups[f"monarch_m{m}"]))
               for m in (1, 2, 3, 4) if f"monarch_m{m}" in systems}
    return {
        "speedup_gmean": {
            s: float(np.exp(np.mean(np.log(np.maximum(speedups[s], 1e-9)))))
            for s in systems},
        "hit_rate_mean": {s: float(np.mean(hitrates[s])) for s in systems},
        "claims": {
            "C1_unbound_vs_dcache": unb,
            "C2_unbound_vs_ideal": unb / ideal,
            "C3_best_m": max(m_means, key=m_means.get),
            "C4_write_filtered_frac": float(np.mean(writes_saved)),
        },
    }


def fig11_numbers(results, states, cfg, specs, n_requests) -> dict:
    """benchmarks/fig11_lifetime.py run's calibration and lifetime
    arithmetic, unchanged, on the port's ``core/lifetime.py``."""
    import numpy as np
    from repro_torch.core import lifetime
    from repro_torch.core.timing import (CPU_HZ, DEFAULT_ENDURANCE,
                                         SECONDS_PER_YEAR)
    snaps = {}
    for spec in specs:
        st = states[(cfg.name, spec.name)]
        snaps[spec.name] = (st.set_writes.cpu().numpy().astype(np.float64),
                            results[(cfg.name, spec.name)])
    w_ep, _ = snaps["EP"]
    epoch_s_ep = (FIG11_EP_IDEAL_YEARS * SECONDS_PER_YEAR
                  * (w_ep.sum() / FIG11_S_REAL) / DEFAULT_ENDURANCE)
    r_req = n_requests / epoch_s_ep
    years_all, ideal_all, ratios = {}, {}, {}
    for spec in specs:
        w, res = snaps[spec.name]
        epoch_seconds = n_requests / r_req
        rotations = res.stats["rotates"]
        lt = lifetime.estimate_lifetime(
            w, epoch_cycles=epoch_seconds * CPU_HZ,
            rotations_per_epoch=rotations, endurance=DEFAULT_ENDURANCE,
            intra_set_skew=FIG11_RESIDUAL_SKEW)
        lt_ss = lifetime.estimate_lifetime(
            w, epoch_cycles=epoch_seconds * CPU_HZ,
            rotations_per_epoch=rotations, endurance=DEFAULT_ENDURANCE)
        scale = FIG11_S_REAL / len(w)
        years_all[spec.name] = lt.years * scale
        ideal_all[spec.name] = lt.ideal_years * scale
        ratios[spec.name] = (lt_ss.years / lt_ss.ideal_years
                             if lt_ss.ideal_years else 1.0)
    mn_app = min(years_all, key=years_all.get)
    return {
        "r_req_calibration": r_req,
        "years": years_all,
        "ideal_years": ideal_all,
        "ss_mechanism_ratio": ratios,
        "claims": {
            "C7_min_years": years_all[mn_app],
            "C7_min_ideal_years": ideal_all[mn_app],
            "C7_min_app": mn_app,
            "C7_ss_mech_ratio_mean": float(np.mean(list(ratios.values()))),
        },
    }


def held_to_baseline(got: dict, bench: str, keys) -> int:
    """Every value under ``keys`` of benchmarks/baselines/BENCH_<bench>.json
    equals the port's, exactly; returns how many were compared."""
    want = json.loads((ROOT / "benchmarks" / "baselines" /
                       f"BENCH_{bench}.json").read_text())
    n = 0
    for key in keys:
        w = want[key]
        g = got[key]
        pairs = w.items() if isinstance(w, dict) else [(None, w)]
        for sub, value in pairs:
            mine = g[sub] if sub is not None else g
            if mine != value:
                raise AssertionError(
                    f"{bench} {key}/{sub}: port {mine!r} != baseline "
                    f"{value!r}")
            n += 1
    return n


def simulator_phase(torch) -> dict:
    """Fig. 9 quick (7 systems x 11 apps, 2 shape families) and Fig. 11
    quick (11 apps through the M=3 config) on the card, with CUDA-graph
    replay; every checked baseline value must be reproduced."""
    n_requests = SIM_REQUESTS
    from repro_torch.core import simulator as sim
    from repro_torch.data import traces

    t0 = time.perf_counter()
    all_cfgs = fig9_configs(sim)
    cfgs = {s: all_cfgs[s] for s in FIG9_SYSTEMS}
    specs = traces.crono_nas_specs(all_cfgs["monarch_unbound"].inpkg_blocks,
                                   n_requests)
    trace_list = [(spec.name, *traces.generate(spec)) for spec in specs]
    gen9_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res9, _, fam9 = run_families(torch, sim, cfgs, trace_list)
    sweep9_s = time.perf_counter() - t0
    fig9 = fig9_numbers(res9, specs, FIG9_SYSTEMS)

    t0 = time.perf_counter()
    cfg11 = fig11_config(sim)
    specs11 = traces.crono_nas_specs(cfg11.inpkg_blocks, n_requests)
    traces11 = [(spec.name, *traces.generate(spec)) for spec in specs11]
    gen11_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res11, st11, fam11 = run_families(torch, sim, {cfg11.name: cfg11},
                                      traces11, return_state=True)
    sweep11_s = time.perf_counter() - t0
    fig11 = fig11_numbers(res11, st11, cfg11, specs11, n_requests)
    peak = max(f["peak_mem_bytes"] for f in fam9 + fam11)

    compared = held_to_baseline(
        fig9, "fig9", ["speedup_gmean", "hit_rate_mean", "claims"])
    compared += held_to_baseline(
        fig11, "fig11", ["r_req_calibration", "years", "ideal_years",
                         "ss_mechanism_ratio", "claims"])
    log(f"phase 7: {compared} Fig. 9/11 baseline values reproduced exactly")
    log(f"phase 7: Fig. 9 sweep {sweep9_s:.1f} s, Fig. 11 sweep "
        f"{sweep11_s:.1f} s, peak device memory of one family's "
        f"simulate_grid {peak / 2 ** 20:.1f} MiB")
    return {"requests": n_requests, "scale_blocks": SIM_SCALE,
            "baseline_values_equal": compared,
            "trace_gen_s": gen9_s + gen11_s,
            "fig9_sweep_s": sweep9_s, "fig11_sweep_s": sweep11_s,
            "peak_mem_bytes": peak, "families": fam9 + fam11,
            "fig9": fig9, "fig11": fig11}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device is visible: this script measures the card")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps.stringmatch import make_corpus

    # float32 matmuls stay full precision (the attention and unembedding
    # contractions run in float32); TF32 would keep ~3 digits.  bf16 GEMMs
    # reduce their split-K partials in float32, as the reference's
    # preferred_element_type contract does, not in bf16.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, numpy {np.__version__}, python "
        f"{sys.version.split()[0]}")
    builds = build_all()

    max_err = check_search_kernel(np, torch)
    timer = CudaTimer(torch)
    timing = time_search_kernel(np, torch, timer)
    shallow = shallow_resume_check(np, torch)
    base_bytes = free_card(torch)
    zero_counts()
    served = serve_phase(np, torch)
    serve_counts = read_counts()
    gemma = gemma_phase(np, torch, smi, base_bytes)
    moe = moe_phase(np, torch, smi, base_bytes)

    t0 = time.perf_counter()
    corpus_t = torch.from_numpy(make_corpus(CORPUS_BYTES, seed=0)).cuda()
    log(f"500 MiB corpus made and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    slice2 = kernels_phase(np, torch, timer, corpus_t)
    table = hashtable_phase(np, torch)
    t0 = time.perf_counter()
    strings = stringmatch_phase(np, torch, corpus_t)
    api = monarch_api_phase(np, torch)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    zero_counts()
    t0 = time.perf_counter()
    simulated = simulator_phase(torch)
    simulated["launches"] = read_counts()
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    path_launches = {
        "xam_search_multiset": (serve_counts["xam_search_multiset"]
                                + gemma["edge"]["launches"]
                                + moe["shards"]["launches"]
                                + moe["edge"]["launches"]),
        "hopscotch_lookup": table["point"]["launches"]["hopscotch_lookup"],
        "string_match": strings["launches"]["string_match"],
        "xam_search": api["launches"]["xam_search"],
    }
    for name, n in path_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    main_row = timing[0]             # the shape the main path's lookups have
    src = "src/repro_torch/kernels/"
    kernels = [{
        "name": "xam_search_multiset",
        "route": "cuda",
        "source": src + "xam_search/csrc/xam_multiset.cu",
        "replaces": "src/repro/kernels/xam_search/kernel.py:225",
        "launches": path_launches["xam_search_multiset"],
        "launches_serve": served["launches"],
        "launches_edge": gemma["edge"]["launches"],
        "launches_shards": moe["shards"]["launches"],
        "launches_moe_edge": moe["edge"]["launches"],
        "launches_per_request_batch": served["launches"] / served["batches"],
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "floor_ms": slice2["xam_search"]["floor_ms"],
        "shapes": timing,
    }]
    # The shape each path runs: the 2^17-slot table at H=32, the 500 MiB
    # corpus, the Fig. 6 search.
    for name, source, replaces, row in [
            ("xam_search", "xam_search/csrc/xam_search.cu",
             "src/repro/kernels/xam_search/kernel.py:118", 0),
            ("hopscotch_lookup", "hopscotch/csrc/hopscotch_lookup.cu",
             "src/repro/kernels/hopscotch/kernel.py:76", 1),
            ("string_match", "string_match/csrc/string_match.cu",
             "src/repro/kernels/string_match/kernel.py:38", 0)]:
        shapes = slice2[name]["shapes"]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": slice2[name]["max_abs_err"],
            "ms": shapes[row]["ms"], "plain_ms": shapes[row]["plain_ms"],
            "bound_ms": shapes[row]["bound_ms"],
            "bound_by": shapes[row]["bound_by"], "library_ms": None,
            "shapes": shapes,
            **{k: v for k, v in slice2[name].items()
               if k not in ("max_abs_err", "shapes")}})
        if name == "hopscotch_lookup":
            kernels[-1]["floor_ms"] = slice2["xam_search"]["floor_ms"]
            kernels[-1]["sector_bound_ms"] = shapes[row]["sector_bound_ms"]
    print(json.dumps({"kernels": kernels, "builds": builds,
                      "serve": served["times"],
                      "resume_check": served["resume_check"],
                      "resume_check_shallow": shallow,
                      "gemma3": gemma, "qwen3_moe": moe,
                      "hashtable": table, "stringmatch": strings,
                      "monarch_api": api, "simulator": simulated,
                      "card": smi}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
