#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises (exit
code 1) on failure:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the Hopper kernel library from ``src/`` (nvcc, into
   ``build/repro_torch/``).
2. Kernel against its plain version on the card: the fused multi-set XAM
   search (CUDA) against ``xam_search_multiset_plain`` over int8 and
   packed8 planes, both scorings, dead blocks, zero-mask rows and empty
   sets — exact equality — then timed with CUDA events (L2 flushed
   before every rep, median of the reps) at three shapes.
3. Serve: ``repro_torch.launch.serve`` at yi-9b full width and depth
   (d_model 4096, 32/4 heads, d_ff 11008, vocab 64000, 48 layers, bf16,
   seeded random weights on the card) answers 8 requests through the
   Monarch index; the launch counts are zeroed just before and read just
   after.  Then resumed prefill against full prefill through the same
   engine — held to fixed ceilings (max |diff| 0.25, at most 3% of
   logits outside rtol 1e-2/atol 5e-2) and to the greedy margin rule —
   and per-stage times.  Before it, the same comparison at full width and
   4 layers is held to rtol 1e-2/atol 5e-2 itself.

The lines before the last are the phase reports, one JSON object with
every kernel's numbers and the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

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

    def graph_ms(self, fn, reps: int = 20) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        both, flush_only = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(both):
            for _ in range(reps):
                self.flush.zero_()
                fn()
        with torch.cuda.graph(flush_only):
            for _ in range(reps):
                self.flush.zero_()
        t_both = statistics.median(self._events_ms(both.replay)
                                   for _ in range(5))
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
        "rows, empty sets)")
    return float(worst)


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
    import dataclasses
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
    from repro_torch.kernels.xam_search import kernel

    # float32 matmuls stay full precision (the attention and unembedding
    # contractions run in float32); TF32 would keep ~3 digits.  bf16 GEMMs
    # reduce their split-K partials in float32, as the reference's
    # preferred_element_type contract does, not in bf16.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    lib = kernel.library()
    log(f"kernel library {lib.path.relative_to(ROOT)} built in "
        f"{lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    max_err = check_search_kernel(np, torch)
    timer = CudaTimer(torch)
    timing = time_search_kernel(np, torch, timer)
    shallow = shallow_resume_check(np, torch)
    served = serve_phase(np, torch)

    main_row = timing[0]             # the shape the main path's lookups have
    kernels = [{
        "name": "xam_search_multiset",
        "route": "cuda",
        "source": "src/repro_torch/kernels/xam_search/csrc/xam_multiset.cu",
        "replaces": "src/repro/kernels/xam_search/kernel.py:225",
        "launches": served["launches"],
        "launches_per_request_batch": served["launches"] / served["batches"],
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": timing,
    }]
    print(json.dumps({"kernels": kernels, "serve": served["times"],
                      "resume_check": served["resume_check"],
                      "resume_check_shallow": shallow, "card": smi}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
