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
   1, 2 and 4 shards under "auto" and "fanout" on the card, and "auto"
   indexes partitioned over ("cuda:0",) * 2, ("cuda:0",) * 4 and the
   mixed ("cuda:0", "cpu", "cuda:0", "cpu"), each equal to a one-shard
   CPU index after every op (planes, counters, wear state, hits, wear
   report); a lookup is one multi-set launch under "auto" on one
   partition, one per shard holding queries under "fanout", and one
   search with one launch per partition on the partitioned indexes,
   whose partitions' tensors lie on their devices; the schedule
   installs, evicts, skips and throttles.  Host-clock medians of a
   lookup and an admission at 1, 2 and 4 partitions (reported).  (b) One qwen3-moe MoE block at full
   width (128 experts, top-8), card against CPU at S = 96 (capacity 7,
   entries dropped) and S = 1: expert ids equal where the 8th/9th router
   gap exceeds 1e-6, outputs within rtol 1e-2/atol 5e-2 but for at most
   0.1% (none past 0.5: bf16 sums that cancel); then 4 MoE layers at
   full width, prefill 2 x 96 and 8 greedy decode steps, tokens equal
   under the margin rule wherever the card routed the row's tokens as the
   CPU did (bf16 noise flips routing in later layers).  (c)
   qwen3-moe-30b-a3b at full width and depth (48 layers, 30.53 B bf16
   parameters, 61.06 GB) behind ``launch/httpd.build_frontend`` with
   ``--n-shards 4``, checked and timed as phase 3b's edge; its
   ``run_request_loop`` replay runs on a fresh index partitioned over
   ("cuda:0",) * 4: every request's hit and resumed chunks equal the
   edge's, and the replay's multi-set launches are 4 x its searches.
3d. The SSM models.  qwen3-moe is freed first and the card's allocated
   memory must be back to its level before phase 3.  (a) One Mamba-1
   block at falcon-mamba-7b's width (d_inner 8192, N 16) and one Mamba-2
   block at zamba2-2.7b's (80 heads of 64, N 64), as a layer group runs
   them: S = 96 with its final state and conv tail, then 8 decode steps
   from them, card against CPU, outputs, float32 states and conv taps
   within rtol 1e-2/atol 5e-2.  (b) falcon-mamba at full width and 4
   layers and zamba2 at full width and one group (6 layers, one shared
   attention call): prefill 2 x 96 tokens and 8 greedy decode steps,
   card against CPU (logits within rtol/atol, tokens under the margin
   rule); then on the card each decode step after prefill(96) against a
   fresh prefill over the 96 + t tokens, held to the reference's
   decode-vs-forward bound (rtol 0.2, atol 0.35, argmax agreeing on at
   least 70%).  (c) falcon-mamba-7b (64 layers, 7.27 B parameters, 14.56
   GB), then zamba2-2.7b (54 layers, 2.06 B), at full width and depth
   behind ``launch/httpd.build_frontend`` on the resume-off path: the
   edge's index counts hits with ``"block"`` fingerprints and no chunk
   resumes; checked and timed as phase 3b's edge, decode beside its
   weight-read bound (every weight but the embedding table, zamba2's
   shared block once per call).
3e. Training.  phase 3d's models are freed first and the card's
   allocated memory must be back to its level before phase 3.  (a) One
   train step (``train.step.loss_and_grads``) at full width, B x S = 2
   x 64, card against CPU from the same float32 masters: yi-9b at 2
   layers with 1 and 2 microbatches, zamba2-2.7b at one group (6 layers,
   one shared-block call), falcon-mamba-7b at 2 layers (the selective
   scan's backward); the loss within 1e-3, the gradients' global norm
   within 2e-2 and every leaf's gradient within 5e-2 relative L2; then
   ``adamw_update`` on both devices with the CPU's gradients, params, m
   and v within 1e-6 of each leaf's largest magnitude.  (b) The 10m
   preset of ``examples/train_lm_torch.py``: 4 steps straight against 2
   steps, ``checkpoint.save``, ``restore_latest`` and 2 more, params
   within rtol 1e-5/atol 1e-6.  (c) zamba2-2.7b at full width and depth
   (2.06 B parameters) through ``repro_torch.launch.train.main``: 6
   steps of 2 x 512 tokens, every loss and gradient norm finite, the
   optimizer step at 6; median step time after the first, tokens/s,
   peak memory and the share of the 6 N tokens model-FLOP bound at the
   dense bf16 peak; then one more step with its FLOPs counted (phase 8).  (d) ``examples/train_lm_torch.py --preset 100m``:
   60 steps of 4 x 256 with a checkpoint at step 30, the loss DOWN, and
   a rerun to 64 steps that restores step 60.  Temporary checkpoint
   directories are removed.  The training path launches none of the
   four kernels.
3f. Training over a ``torch.distributed`` mesh.  Phase 3e's state is
   freed first and the card's allocated memory must be back to its level
   before phase 3.  Every part runs two ranks on ``cuda:0`` (a gloo group:
   NCCL refuses two ranks on one device), each this script spawned as a
   child process (``--mesh-child``); a failed or hung child fails the
   script.  (a) Which collectives the group runs on the card's tensors:
   raw c10d calls and the DTensor redistributions they carry, each
   checked by value or its error recorded; the two that kill the process
   on the card's torch (the functional all-gather, so DTensor's Shard ->
   Replicate) run in pairs of their own, their exit codes recorded.  So
   every move of a placed tensor, serving (phase 3g (c), (d)) and
   training ((c) below), goes by raw collectives.  (b) zamba2-2.7b at
   full width and 6 layers on a ``(2, 1)`` ``("data", "model")`` mesh, 2 x 512
   tokens (one row a rank): rank 0 first runs the one-process step of the
   same seed and batch on the card; then ``init_state`` places the state
   over the mesh and one step runs; the loss within 1e-3, the gradient
   norm within 2e-2 and lr within 1e-6 of the one-process step, the same
   on both ranks, every gathered leaf held as
   ``tests/test_torch_mesh_train.py`` holds it (params within ``2 lr (1
   + wd |p0|) + 1e-7``, m and v within 5e-2 and 1e-1 relative L2); the
   placed state saved on both ranks and restored by rank 0 bit for bit;
   each rank's collectives and their output bytes
   (``roofline.analysis.CollectiveCounter`` over the first step), both
   steps' seconds and its peak memory.  (c) The model split over the two
   ranks, on ``(1, 2)``, in (b)'s pair of processes: (b)'s configuration
   held to the same one-process step (not run again), then yi-9b at full
   width and 2 layers (its vocabulary split over ``model`` in the
   embedding and unembedding, its 4 KV heads over 2) held to its own
   one-process step, which rank 0 runs first; (b)'s bounds and records
   (zamba2-2.7b's checkpoint too; yi-9b's 10.4 GB state is not saved,
   for the script's time), and both steps of each under a collective
   counter that refuses, by name and before it runs, a functional
   all-gather (``roofline.analysis.NoFunctionalGather``): every gather
   and cut of the forward, the recomputation, the backward and AdamW is
   ``dist/sharding.py``'s raw one.
3g. Serving over a ``torch.distributed`` mesh.  Phase 3f's ranks are
   gone and the card's allocated memory must be back to its level before
   phase 3.  Every part runs two ranks on ``cuda:0`` (gloo) under
   ``python -m torch.distributed.run --standalone --nproc-per-node 2``,
   each rank this script (``--torchrun-child``) calling the launcher;
   (a), (c) and (d) run in turn in one such launch (``SERVE_PARTS``).
   (a) ``launch/serve.serve`` with phase 3's arguments and ``--mesh
   host``: yi-9b at full width and depth placed over ``(2, 1)``, an index
   replica a rank; both ranks' records equal; chunks, hits, resumed
   chunks and admissions equal phase 3's one-process run; greedy tokens
   under the margin rule with phase 3's top-2 gaps; a full prefill of the
   last batch within phase 3's 48-layer ceilings of the one-process
   logits; each rank's multi-set launches equal its searches; each
   rank's collectives (output bytes), local parameter bytes and peak.
   (b) ``launch/httpd.main --mesh host`` with qwen3-moe-30b-a3b at full
   width and 4 of its 48 layers, ``--n-shards 4``: 8 requests of two
   96-token rows (sharing a 48-token prefix) first through the edge's
   request loop in this process, each request's rows served alone at
   B = 1 with the batch's lookups, resume run and admissions (its top-2
   gaps recorded), then through rank 0 of the mesh (rank 1 follows the
   broadcast batches; each rank serves one row); chunks, hits, resumed
   chunks and admissions equal, tokens under the margin rule; the loop
   run again and at B = 2 are measured beside it; a SIGTERM to torchrun
   drains both ranks.  (c) (a) on a ``(1, 2)`` mesh (model parallel:
   every weight split over ``model`` by ``param_specs``, each gather of
   the path by the raw all-gather), held as (a) is.  (d) zamba2-2.7b at
   full width and one layer group (6 layers), resume off, phase 3's
   requests on ``(1, 2)``: chunks, hits and admissions equal a
   one-process run of the same config in this process, tokens under its
   margin rule; one decode step's all-gather bytes a rank equal the
   activation figure (``ssm_step_gather_bytes``: each Mamba-2 layer
   gathers its step's activations, no weight), beside the step's time.
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
   the peak device memory.  Then the first Fig. 9 family whose lanes
   split in two runs again through ``simulate_grid(devices=("cuda:0",
   "cuda:0"))`` (two blocks of lanes, one run each): every result and
   final state equal to the sweep's.  The path launches none of the four kernels.
8. The tooling.  (a) ``roofline.analysis.current_machine()`` must be
   ``h100-sxm`` on the card (the bounds above read that profile).  (b)
   ``kernels.autotune.autotune`` sweeps the multi-set search's query-block
   width into a temporary cache (int8 and packed8, block_q 8 to 128, at
   the batches the serving path sends: 12 and 96 queries over 8 sets,
   256 over 32, 4096 over 128), timing each by CUDA-graph replay (warm
   L2); every candidate's answers, on the sweep's inputs and with
   planted hits, equal the cold width's and the plain version's bit for
   bit, and each candidate's cold-L2 device time (``graph_ms``) stands
   beside the sweep's; the sweep's launches are ``launches_autotune``,
   apart from the main path's.  (c) One lookup
   batch per format and bucket through a ``MonarchKVIndex`` on the card
   under the cold and the swept cache: ways, hits and counters equal.
   (d) ``bench.time_callable`` of an 8192^2 bf16 matmul is at least 0.9
   of its CUDA-event time (``_block`` synchronised), and ``emit_json``'s
   envelope read back names the card, its power limit, ``h100-sxm`` and
   the swept cache's fingerprint.  (e) Phase 3e's counted zamba2-2.7b
   step (``roofline.jaxpr_cost.step_flops``) beside ``model_flops`` and
   the median step time.
9. The launch layer and the examples.  (a) ``launch.dryrun.run_cell`` of
   every cell of ``configs.all_cells()`` on the card's host mesh, the
   steps run on ``meta`` tensors (layer groups extrapolated, exactly,
   where a full trace would take over a second): one line per cell with its input bytes
   per device against the card's memory, its counted FLOPs,
   ``model_flops``, the roofline terms on ``h100-sxm`` and the
   bottleneck, the counting method and its seconds; a runnable cell that
   fails to trace raises.  (b) zamba2-2.7b's train step dry-run at phase
   3e's 2 x 512: its FLOPs equal phase 8's counted step on the card
   exactly, and its input bytes do not exceed phase 3e's peak.  (c)
   ``examples/quickstart_torch.py``, ``kv_store_torch.py``,
   ``string_search_torch.py`` and ``serve_prefix_cache_torch.py`` with
   ``--device cpu`` and then ``--device cuda``: the same lines but for
   host times and the route an example names, and the card's run
   launches each example's kernels (the flat search; the flat search and
   the hopscotch lookup; the string match; the multi-set search).

Every path's launch counts are zeroed just before it and read just after.
The lines before the last are the phase reports, then three JSON
objects (every phase's report, the tooling's, every kernel's numbers)
and the card's ``nvidia-smi`` name and power limit; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
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


def h100():
    """The H100 SXM roofline profile (``repro_torch.roofline.analysis``):
    ``hbm_bw`` (3.35 TB/s of HBM3) and ``peak_flops`` (989 TFLOP/s dense
    bf16) bound every kernel, decode and training time below."""
    from repro_torch.roofline.analysis import MACHINES
    return MACHINES["h100-sxm"]


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
    block_q = ops._pick_block_q(n_q, None, "packed8" if packed else "int8",
                                torch.device("cuda"))
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
            t_bytes = n_bytes / h100().hbm_bw * 1e3
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
    gaps = RecordedGaps(np)                  # phase 3g's margin reference
    run = serve.serve(args, on_logits=gaps.record)
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
    memory = serve_step_memory(np, torch, "yi-9b", run.params, toks)
    one = {"records": [[r.chunks, r.hit_chunks, r.resumed_chunks,
                        int(r.admitted), r.decoded.tolist()] for r in recs],
           "gaps": [g.tolist() for g in gaps.per_request(8)],
           "admissions": s.admissions, "seconds": run.seconds,
           "logits_full_last": b}
    return {"launches": launches, "batches": len(recs), "times": times,
            "one_process": one, "step_memory": memory,
            "resume_check": {"max_abs_diff": d_res, "outside_tol": over(a, b),
                             "floor_max_abs_diff": d_floor,
                             "floor_outside_tol": over(rows, b),
                             "decoded_agree": agree}}


#: Phase 9 (b)'s serving steps, run where phase 3 holds yi-9b: (ii) the
#: full prefill of its last batch and (iii) one decode step on that cache
SERVE_MEMORY_SHAPES = {"prefill": ("prefill_2x96", 96, 2, "prefill"),
                       "decode": ("decode_2x96", 96, 2, "decode")}
ALLOCATOR_BLOCK = 512              # the caching allocator's rounding


def step_memory(torch, fn, args) -> dict:
    """One step ``fn(*args)`` on the card: the bytes the allocator holds
    for its arguments (each storage once, in whole 512-byte blocks), the
    step's peak beyond what was allocated at its entry
    (``max_memory_allocated() - memory_allocated()``, the peak reset just
    before), and the same step run again under
    ``jaxpr_cost.MemoryCounterMode``: the dry run's count on the card's
    own tensors, which parts what the allocator adds (workspaces,
    rounding) from what the card runs otherwise than ``meta``."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.roofline.jaxpr_cost import MemoryCounterMode

    torch.cuda.synchronize()
    entry = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - entry
    del out
    counter = MemoryCounterMode(args)
    with counter:
        out = fn(*args)
    counted = counter.result(out)
    del out
    torch.cuda.synchronize()
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tree_leaves(args)
                if isinstance(t, torch.Tensor) and t.is_cuda}
    held = sum(-(-n // ALLOCATOR_BLOCK) * ALLOCATOR_BLOCK
               for n in storages.values())
    return {"entry_bytes": entry, "argument_bytes": held,
            "step_peak_bytes": peak, "counted_on_card": counted}


def serve_step_memory(np, torch, arch: str, params, toks,
                      kinds=("prefill", "decode")) -> dict:
    """``arch``'s full prefill of ``toks`` (2 x 96 tokens, every layer)
    through ``serve/step.make_prefill_step`` and one decode step on its
    cache through ``make_decode_step``, each the dry run's own step
    (``launch.dryrun.build_cell``: the decode at the cache's last slot),
    measured by :func:`step_memory` on ``params``, the phase's own: (ii)
    and (iii) of phase 9 (b) for yi-9b, and its MoE prefill for
    qwen3-moe-30b-a3b."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg, mesh = get_arch(arch), make_host_mesh()
    steps = {kind: dryrun.build_cell(
        cfg, ShapeConfig(*SERVE_MEMORY_SHAPES[kind]), mesh)[0]
        for kind in kinds}
    tokens = torch.from_numpy(np.ascontiguousarray(toks, np.int32)).cuda()
    batch = {"tokens": tokens}
    out = {"prefill": step_memory(torch, steps["prefill"], (params, batch))}
    if "decode" in kinds:
        _, cache = steps["prefill"](params, batch)
        last = tokens.new_tensor(SERVE_MEMORY_SHAPES["decode"][1] - 1)
        out["decode"] = step_memory(torch, steps["decode"], (
            params, cache, tokens[:, -1:].contiguous(), last))
        del cache
    for kind, m in out.items():
        log(f"{arch} {kind} step on the card (2 x 96, {cfg.n_layers} "
            f"layers): arguments {m['argument_bytes']} B, step peak "
            f"{m['step_peak_bytes']} B over {m['entry_bytes']} B at entry; "
            f"counted on the card: {m['counted_on_card']}")
    return out


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


def decode_read_bytes(cfg, params) -> int:
    """Bytes of weights one decode step must read: every leaf but the
    embedding table (a step gathers its B rows), and a shared block's
    leaves once per call (zamba2: 9 calls)."""
    from repro_torch.configs.base import SHARED_ATTN
    from repro_torch.pytree import tree_leaves
    size = lambda t: sum(a.numel() * a.element_size() for a in tree_leaves(t))
    n = size(params)
    if not cfg.tie_embeddings:
        n -= size(params["embed"]["embed"])
    if "shared" in params:
        n += (cfg.layer_pattern().count(SHARED_ATTN) - 1) * size(
            params["shared"])
    return n


def edge_phase(np, torch, smi: str, argv: list, dims: dict,
               check_tree, resume: bool = True,
               replay_devices: tuple | None = None,
               memory_kinds: tuple = ()) -> dict:
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
    taken on that engine.  With ``replay_devices`` that index is
    partitioned over them: every request's hit and resumed chunks must
    equal the edge's, and the replay's multi-set launches must be one
    per partition per search.  ``resume=False`` is the path of a recurrent
    model: the edge must report resume off, the index (``"block"``
    fingerprints, no slab store) must hit and no chunk may resume; the
    replay and its times run the plain prefill and decode.
    ``memory_kinds`` are the serving steps :func:`serve_step_memory`
    then measures on the edge's parameters."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.xam_search import ops
    from repro_torch.launch import httpd
    from repro_torch.launch.serve import build_model_fns, run_request_loop
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_leaves
    from repro_torch.serve.admit_queue import AdmitQueue
    from repro_torch.serve.kv_index import (KVIndexConfig, KVSlabStore,
                                            MonarchKVIndex)
    from repro_torch.serve.step import make_decode_step

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
        f" GB of weights) drawn on the card in {init_s:.1f} s")

    rng = np.random.default_rng(0)
    prefix = rng.integers(1, cfg.vocab_size, 48)
    batches = [np.concatenate([np.tile(prefix, (2, 1)), rng.integers(
        1, cfg.vocab_size, (2, 48))], axis=1).astype(np.int32)
        for _ in range(EDGE_REQUESTS)]

    zero_counts()
    frontend, admit_q = httpd.build_frontend(args, params=params)
    idx = admit_q.index
    if (idx.slab_store is not None) != resume or \
            idx.cfg.fingerprint != ("prefix" if resume else "block"):
        raise AssertionError(f"{cfg.name}: the edge's index is not on the "
                             f"resume={'on' if resume else 'off'} path")
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
    resumed = [a["resumed_chunks"] for a in answers]
    if idx.hit_rate <= 0 or (sum(resumed[1:]) <= 0 if resume
                             else any(resumed)):
        raise AssertionError(f"index hit rate {idx.hit_rate}, resumed "
                             f"chunks {resumed} with resume "
                             f"{'on' if resume else 'off'}")
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
        f"{launches['xam_search_multiset']} launches, resume "
        f"{'on' if resume else 'off'}, resumed chunks {resumed}, drain "
        f"{drain_s:.2f} s, /stats hit rate {stats['index']['hit_rate']}")

    # The same requests through run_request_loop on a fresh index.
    kv_cfg = KVIndexConfig(n_sets=8, m_writes=args.m_writes,
                           clock=args.wear_clock,
                           fingerprint="prefix" if resume else "block",
                           admit_after_reads=0, n_shards=args.n_shards)
    idx2 = MonarchKVIndex(kv_cfg, slab_store=KVSlabStore() if resume
                          else None, device="cuda", devices=replay_devices)
    n_parts = 1 if replay_devices is None else len(replay_devices)
    if idx2.n_parts != n_parts:
        raise AssertionError(f"replay index in {idx2.n_parts} partitions")
    q2 = AdmitQueue(idx2)
    max_seq = args.prompt_len + args.decode_tokens
    prefill_fn, plain_decode, eng = build_model_fns(
        params, cfg, max_seq=max_seq, decode_tokens=8, index=idx2,
        resume=resume)
    step = make_decode_step(cfg)
    gaps = []

    def decode_fn(toks, result):
        if resume:
            st = result.state
            logits, cache, pos = st["logits"], st["cache"], st["pos"]
        else:
            (logits, cache), pos = result, toks.shape[1]
        out, g = [], []
        for t in range(8):
            lg = logits.float().cpu().numpy()
            out.append(lg.argmax(-1))
            g.append(top2_gap(np, lg))
            if t < 7:
                nxt = torch.from_numpy(out[-1][:, None]).cuda()
                _, logits, cache = step(params, cache, nxt, pos + t)
        gaps.append(np.stack(g, 1))
        return np.stack(out, 1).astype(np.int32)

    zero_counts()
    recs = run_request_loop(q2, batches, prefill_fn=prefill_fn,
                            decode_fn=decode_fn)
    q2.flush()
    replay_launches = read_counts()["xam_search_multiset"]
    replay_searches = idx2.stats.searches
    if replay_launches != n_parts * replay_searches:
        raise AssertionError(f"replay: {replay_launches} multi-set launches "
                             f"for {replay_searches} searches over "
                             f"{n_parts} partitions")
    if replay_devices is not None:
        got = [(r.hit_chunks, r.resumed_chunks) for r in recs]
        want = [(a["hit_chunks"], a["resumed_chunks"]) for a in answers]
        if got != want:
            raise AssertionError(f"replay over {n_parts} partitions: hit "
                                 f"and resumed chunks {got} != the edge's "
                                 f"{want}")
    for i, (rec, tk) in enumerate(zip(recs, edge_tokens)):
        if not greedy_margin_agree(tk, rec.decoded, gaps[i]):
            raise AssertionError(f"request {i}: the edge's greedy tokens "
                                 "differ from the replay's where the "
                                 "top-1/top-2 gap exceeds 0.1")
    agree = float(np.mean([(tk == r.decoded).mean()
                           for tk, r in zip(edge_tokens, recs)]))

    # Per-stage times on the replay's engine (host clock, each ending in
    # a synchronisation); a decode time covers 8 emitted tokens from one
    # prefill's state, whose cache it updates in place.
    toks = batches[-1]
    hits = idx2.lookup(toks)
    fresh = np.random.default_rng(5).integers(1, 2 ** 32, (16, 12),
                                              dtype=np.uint32)
    it = iter(fresh)
    read_bytes = decode_read_bytes(cfg, params)
    times = {"lookup_ms": host_ms(torch, lambda: idx2.lookup(toks), 10)}
    if resume:
        full = eng.prefill(toks, None)
        times["resumed_chunks_timed"] = eng.prefill(toks, hits).resumed_chunks
        times["prefill_resumed_ms"] = host_ms(
            torch, lambda: eng.prefill(toks, hits), 3)
        times["prefill_full_ms"] = host_ms(
            torch, lambda: eng.prefill(toks, None), 3)
        times["decode_ms_per_token"] = host_ms(
            torch, lambda: eng.decode(full, 8), 3) / 8
    else:
        full = prefill_fn(toks, hits)
        times["prefill_full_ms"] = host_ms(
            torch, lambda: prefill_fn(toks, hits), 3)
        times["decode_ms_per_token"] = host_ms(
            torch, lambda: plain_decode(toks, full), 3) / 8
    times.update({
        "admit_ms": host_ms(torch, lambda: idx2.admit_fps(next(it)), 10),
        "edge_latency_ms": latency_ms,
        "edge_latency_ms_median": statistics.median(latency_ms),
        "edge_server_ms": [a["server_ms"] for a in answers],
        "init_s": init_s, "drain_s": drain_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_bound_ms": weight_bytes / h100().hbm_bw * 1e3,
        "decode_read_gb": read_bytes / 1e9,
        "decode_read_bound_ms": read_bytes / h100().hbm_bw * 1e3,
    })
    q2.close()
    log("edge stage times (" + smi + "): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float)))
    memory = (serve_step_memory(np, torch, cfg.name, params, toks,
                                memory_kinds) if memory_kinds else None)
    return {"arch": cfg.name, "n_shards": idx.n_shards, "resume": resume,
            "step_memory": memory,
            "launches": launches["xam_search_multiset"],
            "replay_partitions": n_parts,
            "replay_launches": replay_launches,
            "replay_searches": replay_searches,
            "searches": s.searches, "requests": EDGE_REQUESTS,
            "hit_rate": idx.hit_rate, "resumed_chunks": resumed,
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
# Partitioned "auto" indexes: several partitions on the one card (the
# counterpart of the reference's forced host devices), and a mixed list
# whose boundary exchange moves sets between the card and the CPU.
PART_DEVICES = {"2 x cuda:0": ("cuda:0",) * 2, "4 x cuda:0": ("cuda:0",) * 4,
                "mixed": ("cuda:0", "cpu", "cuda:0", "cpu")}
REPLAY_DEVICES = ("cuda:0",) * 4   # phase 3c (c)'s run_request_loop index
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
    """(a) Logical shards and partitions on the card: one seeded admit/
    re-offer/lookup/rotate schedule through indexes of 1, 2 and 4 shards
    under "auto" and "fanout" on the card, and the partitioned "auto"
    indexes of ``PART_DEVICES``, beside a one-shard index on the CPU.
    After every op every index's global state equals the CPU's; a lookup
    is one multi-set launch under "auto" on one partition, one per shard
    holding queries under "fanout", and one search with one launch per
    partition (kernel on a card partition, plain version on a CPU one)
    on the partitioned indexes, whose partitions' tensors lie on their
    devices.  The schedule must install, evict, skip (no-allocate) and
    throttle.  Then host-clock medians of a 12-chunk lookup and a
    12-fingerprint admission at 1, 2 and 4 partitions on the card."""
    from repro_torch.data.pipeline import fingerprint_blocks
    from repro_torch.kernels.xam_search import ops
    from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                            MonarchKVIndex)

    idxs = {(n, d): MonarchKVIndex(KVIndexConfig(n_shards=n, **SHARD_CFG),
                                   dispatch=d, device="cuda")
            for n in (1, 2, 4) for d in ("auto", "fanout")}
    parts = {name: MonarchKVIndex(KVIndexConfig(n_shards=len(devs),
                                                **SHARD_CFG),
                                  device="cuda", devices=devs)
             for name, devs in PART_DEVICES.items()}
    for name, idx in parts.items():
        devs = [torch.device(d) for d in PART_DEVICES[name]]
        if idx.n_parts != len(devs) or idx.set_mesh is None:
            raise AssertionError(f"{name}: {idx.n_parts} partitions")
        for k, dev in enumerate(devs):
            held = (idx._bits[k], idx._valid[k], idx._fp_of[k],
                    idx._read_after[k], idx._counters[k],
                    idx._wear_states[k].window_writes,
                    idx._wear_dyns[k].t_mww_cycles, idx._admit_after[k])
            if any(t.device != dev for t in held):
                raise AssertionError(f"{name}: partition {k} not on {dev}")
    cpu = MonarchKVIndex(KVIndexConfig(**SHARD_CFG), device="cpu")
    every = [cpu, *idxs.values(), *parts.values()]
    rng = np.random.default_rng(17)
    per_lookup = {"auto": [], "fanout": [], "partitioned": []}
    card_parts = {name: sum(torch.device(d).type == "cuda" for d in devs)
                  for name, devs in PART_DEVICES.items()}
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
            for name, idx in parts.items():
                before, searches = ops.LAUNCH_COUNT, idx.stats.searches
                got = idx.lookup(toks)
                made = ops.LAUNCH_COUNT - before
                if made != idx.n_parts or idx.stats.searches != searches + 1:
                    raise AssertionError(f"{name}: {made} launches, "
                                         f"{idx.stats.searches - searches} "
                                         "searches in one lookup")
                if not np.array_equal(got, want):
                    raise AssertionError(f"{name}: hits differ")
                per_lookup["partitioned"].append(card_parts[name])
        else:
            for idx in every:
                idx._rotate()
        want = index_state(np, cpu)
        for key, idx in [*idxs.items(), *parts.items()]:
            if not same_state(np, index_state(np, idx), want):
                raise AssertionError(f"step {step}: the {key} index "
                                     "differs from the CPU's")
    st = cpu.stats
    if not (st.admissions and st.evictions and st.admission_skips
            and st.throttled and st.rotations and per_lookup["auto"]):
        raise AssertionError(f"schedule too tame: {st}")
    # Host-clock times at 4 shards: a 12-chunk lookup, and the admission
    # of 12 fresh fingerprints (one round-grid dispatch under "auto",
    # the per-candidate scans of each partition under "fanout").
    fresh = iter(rng.integers(1, 2 ** 32, (80, 12), dtype=np.uint32))
    before = ops.LAUNCH_COUNT
    times = {d: {"lookup_ms": host_ms(torch, lambda: idxs[4, d].lookup(
                     toks), 10),
                 "admit_ms": host_ms(torch, lambda: idxs[4, d].admit_fps(
                     next(fresh)), 10)}
             for d in ("auto", "fanout")}
    # 1, 2 and 4 partitions of the card (4 shards in one partition, then
    # the partitioned indexes of 2 and 4).
    by_parts = {1: idxs[4, "auto"], 2: parts["2 x cuda:0"],
                4: parts["4 x cuda:0"]}
    part_times = {n: {"lookup_ms": host_ms(torch, lambda: idx.lookup(toks),
                                           10),
                      "admit_ms": host_ms(torch, lambda: idx.admit_fps(
                          next(fresh)), 10)}
                  for n, idx in by_parts.items()}
    timing_launches = ops.LAUNCH_COUNT - before
    log(f"shards: {SHARD_STEPS} ops at 1/2/4 shards, auto and fanout, and "
        f"partitioned over {list(PART_DEVICES)}, equal the CPU after every "
        f"op; launches per lookup auto {per_lookup['auto']}, fanout "
        f"{per_lookup['fanout']}, partitioned (card launches) "
        f"{per_lookup['partitioned']}; {st.admissions} installs, "
        f"{st.evictions} evictions, {st.admission_skips} skips, "
        f"{st.throttled} throttles; at 4 shards lookup / admission of 12 "
        f"ms: auto {times['auto']['lookup_ms']:.4f} / "
        f"{times['auto']['admit_ms']:.4f}, fanout "
        f"{times['fanout']['lookup_ms']:.4f} / "
        f"{times['fanout']['admit_ms']:.4f}; at 1/2/4 partitions: " +
        ", ".join(f"{n}: {t['lookup_ms']:.4f} / {t['admit_ms']:.4f}"
                  for n, t in part_times.items()))
    lookups = len(per_lookup["auto"]) // 3
    mixed_cpu = len(PART_DEVICES["mixed"]) - card_parts["mixed"]
    return {"ops": SHARD_STEPS, "lookups": lookups,
            "launches_per_lookup": per_lookup,
            "launches": (sum(per_lookup["auto"]) + sum(per_lookup["fanout"])
                         + sum(per_lookup["partitioned"])),
            "cpu_plain_runs": lookups * (1 + mixed_cpu),
            "timing_launches": timing_launches,
            "installs": st.admissions, "evictions": st.evictions,
            "skips": st.admission_skips, "throttles": st.throttled,
            "rotations": st.rotations, "times_at_4_shards": times,
            "times_by_partitions": part_times,
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
    ``--n-shards 4``, and its MoE prefill's memory (phase 9 (b))."""
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
    edge = edge_phase(np, torch, smi, MOE_EDGE_ARGV, QWEN_DIMS, qwen_tree,
                      replay_devices=REPLAY_DEVICES,
                      memory_kinds=("prefill",))
    free_card(torch)
    log(f"phase 3c: {time.perf_counter() - t0:.1f} s")
    return {"shards": shards, "moe": layer, "edge": edge,
            "allocated_after_phase3b_bytes": left}


# ---------------------------------------------------------------------------
# Phase 3d: Mamba-1 and Mamba-2 blocks; falcon-mamba-7b and zamba2-2.7b
# behind the edge on the resume-off path.
# ---------------------------------------------------------------------------

SSM_PREFILL = 96                   # Mamba-1: chunks of 64 and 32 (padded)
SSM_DECODE = 8
FALCON_DIMS = {"n_layers": 64, "d_model": 4096, "ssm_state": 16,
               "ssm_expand": 2, "ssm_conv": 4, "vocab_size": 65024}
ZAMBA_DIMS = {"n_layers": 54, "d_model": 2560, "n_heads": 32,
              "n_kv_heads": 32, "d_head": 80, "d_ff": 10240,
              "ssm_state": 64, "ssm_head_dim": 64, "shared_attn_every": 6,
              "vocab_size": 32000}
#: layers of the card-vs-CPU stacks: falcon-mamba 4, zamba2 one group
SSM_FEW_LAYERS = {"falcon-mamba-7b": 4, "zamba2-2.7b": 6}
#: the reference's own decode-vs-forward bound for the recurrent archs
#: (tests/test_models.py::test_decode_matches_forward)
HANDOFF_RTOL, HANDOFF_ATOL, HANDOFF_AGREE = 0.2, 0.35, 0.7


def edge_argv(arch: str) -> list:
    return [arch if a == "gemma3-27b" else a for a in EDGE_ARGV]


def falcon_tree(params) -> None:
    b0 = params["groups"]["b0"]
    if sorted(params["groups"]) != ["b0"] or sorted(b0) != ["ln1", "ssm"] \
            or tuple(b0["ssm"]["a_log"].shape) != (64, 8192, 16) or \
            b0["ssm"]["a_log"].dtype.itemsize != 4:
        raise AssertionError("falcon-mamba-7b's tree is not 64 x b0 of "
                             "Mamba-1 with float32 a_log")


def zamba_tree(params) -> None:
    if sorted(params["groups"]) != [f"b{i}" for i in range(5)] or \
            "shared" not in params or "rem0" in params or \
            tuple(params["groups"]["b0"]["ssm"]["wz"].shape) != (9, 2560,
                                                                 5120):
        raise AssertionError("zamba2-2.7b's tree is not 9 x b0..b4 of "
                             "Mamba-2 and one shared block")


def diff_stats(np, got, want) -> tuple[float, float]:
    """(max |diff|, share outside RTOL/ATOL) of a card tensor against
    the CPU's."""
    a, b = got.float().cpu().numpy(), want.float().numpy()
    if not np.isfinite(a).all():
        raise AssertionError("non-finite values on the card")
    d = np.abs(a - b)
    return float(d.max()), float((d > ATOL + RTOL * np.abs(b)).mean())


def ssm_block_check(np, torch) -> list:
    """(a) One Mamba-1 block at falcon-mamba's width (d_inner 8192, N 16)
    and one Mamba-2 block at zamba2's (80 heads of 64, N 64), seeded
    weights drawn on the card, run as a layer group runs them
    (``fused``): S = 96 with ``return_state``, then 8 decode steps from
    that state, card against CPU; outputs, float32 states and conv taps
    held to RTOL/ATOL."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm
    from repro_torch.pytree import tree_map

    rows = []
    for kind, arch, dims in (("mamba1", "falcon-mamba-7b", FALCON_DIMS),
                             ("mamba2", "zamba2-2.7b", ZAMBA_DIMS)):
        cfg = get_arch(arch)
        if {k: getattr(cfg, k) for k in dims} != dims:
            raise AssertionError(f"not {arch} at full width")
        init, blk, dec = {"mamba1": (ssm.init_mamba1, ssm.mamba1_block,
                                     ssm.mamba1_decode),
                          "mamba2": (ssm.init_mamba2, ssm.mamba2_block,
                                     ssm.mamba2_decode)}[kind]
        p = init(torch.Generator(device="cuda").manual_seed(5), cfg)
        p_cpu = tree_map(lambda a: a.cpu(), p)
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.standard_normal(
            (2, SSM_PREFILL, cfg.d_model)).astype(np.float32)).to(
            torch.bfloat16)
        o, h, c = blk(p, x.cuda(), cfg, return_state=True, fused=True)
        oc, hc, cc = blk(p_cpu, x, cfg, return_state=True, fused=True)
        stats = {"out": [diff_stats(np, o, oc)], "h": [diff_stats(np, h, hc)],
                 "conv": [diff_stats(np, c, cc)]}
        xs = [torch.from_numpy(rng.standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(SSM_DECODE)]
        for xt in xs:
            o = dec(p, xt.cuda(), cfg, h, c, fused=True)[0]
            oc = dec(p_cpu, xt, cfg, hc, cc, fused=True)[0]
            for k, (a, b) in (("out", (o, oc)), ("h", (h, hc)),
                              ("conv", (c, cc))):
                stats[k].append(diff_stats(np, a, b))
        worst = {k: (max(m for m, _ in v), max(f for _, f in v))
                 for k, v in stats.items()}
        xc = x.cuda()
        block_ms = host_ms(torch, lambda: blk(p, xc, cfg, return_state=True,
                                             fused=True), 3)
        xt = xs[0].cuda()
        step_ms = host_ms(torch, lambda: dec(p, xt, cfg, h, c, fused=True), 10)
        log(f"{kind} block at {arch} width, S={SSM_PREFILL} + "
            f"{SSM_DECODE} decode steps, card vs CPU: " + ", ".join(
                f"{k} max |diff| {m:.6f} ({f:.6f} outside)"
                for k, (m, f) in worst.items())
            + f"; block {block_ms:.3f} ms, decode step {step_ms:.3f} ms")
        if any(f > 0 for _, f in worst.values()):
            raise AssertionError(f"{kind} block card vs CPU exceeds rtol "
                                 f"{RTOL}/atol {ATOL}: {worst}")
        rows.append({"kind": kind, "arch": arch,
                     **{f"{k}_max_abs_diff": m for k, (m, _) in worst.items()},
                     "block_ms": block_ms, "decode_step_ms": step_ms})
        del p, p_cpu, h, c
    return rows


def ssm_layers_check(np, torch, arch: str) -> dict:
    """(b) ``arch`` at full width and ``SSM_FEW_LAYERS`` layers (seeded
    weights drawn on the card, copied to the CPU): prefill 2 x 96 tokens
    and 8 greedy decode steps (the CPU's token fed to both), card against
    CPU, logits within RTOL/ATOL and greedy tokens under the margin rule.
    Then the state handoff on the card: after prefill(96), each decode
    step's logits against a fresh prefill over the 96 + t tokens, held to
    the reference's decode-vs-forward bound (rtol 0.2, atol 0.35, argmax
    agreeing on at least 70%): the chunked and the stepwise scans round
    differently."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_map

    cfg = dataclasses.replace(get_arch(arch), n_layers=SSM_FEW_LAYERS[arch])
    params = transformer.init_params(cfg, seed=7, device="cuda")
    params_cpu = tree_map(lambda a: a.cpu(), params)
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size,
                                             (2, SSM_PREFILL))
    max_seq = SSM_PREFILL + SSM_DECODE
    lg, cache = transformer.prefill(params, cfg, {"tokens": toks}, max_seq)
    lc, cache_c = transformer.prefill(params_cpu, cfg, {"tokens": toks},
                                      max_seq)
    d_max, out_max, got, want, gaps = 0.0, 0.0, [], [], []
    for t in range(SSM_DECODE):
        m, f = diff_stats(np, lg, lc)
        d_max, out_max = max(d_max, m), max(out_max, f)
        b = lc.numpy()
        got.append(lg.float().cpu().numpy().argmax(-1))
        want.append(b.argmax(-1))
        gaps.append(top2_gap(np, b))
        nxt = want[-1][:, None]
        lg, cache = transformer.decode_step(params, cfg, nxt, cache,
                                            SSM_PREFILL + t)
        lc, cache_c = transformer.decode_step(params_cpu, cfg, nxt, cache_c,
                                              SSM_PREFILL + t)
    if out_max > 0 or not greedy_margin_agree(
            np.stack(got, 1), np.stack(want, 1), np.stack(gaps, 1)):
        raise AssertionError(f"{arch} at {cfg.n_layers} layers, card vs CPU: "
                             f"logits max |diff| {d_max}, {out_max} outside "
                             f"rtol {RTOL}/atol {ATOL}, or greedy tokens "
                             "differ past the margin")
    agree = float((np.stack(got) == np.stack(want)).mean())

    # the handoff: decode from prefill(96) against fresh prefills
    seq = toks.copy()
    lg, cache = transformer.prefill(params, cfg, {"tokens": seq}, max_seq)
    h_max, h_agree = 0.0, []
    for t in range(SSM_DECODE):
        nxt = lg.argmax(-1).cpu().numpy()[:, None]
        seq = np.concatenate([seq, nxt], axis=1)
        lg, cache = transformer.decode_step(params, cfg, nxt, cache,
                                            SSM_PREFILL + t)
        fresh, _ = transformer.prefill(params, cfg, {"tokens": seq}, max_seq)
        a, b = lg.float().cpu().numpy(), fresh.float().cpu().numpy()
        d = np.abs(a - b)
        h_max = max(h_max, float(d.max()))
        if (d > HANDOFF_ATOL + HANDOFF_RTOL * np.abs(b)).any():
            raise AssertionError(f"{arch}: decode after prefill vs a fresh "
                                 f"prefill at step {t}: max |diff| {d.max()}")
        h_agree.extend(a.argmax(-1) == b.argmax(-1))
    if float(np.mean(h_agree)) < HANDOFF_AGREE:
        raise AssertionError(f"{arch}: the handoff's argmax agrees on "
                             f"{np.mean(h_agree)} of steps")
    log(f"{arch} at full width, {cfg.n_layers} layers, prefill "
        f"{SSM_PREFILL} + {SSM_DECODE} decode steps, card vs CPU: logits "
        f"max |diff| {d_max:.6f}, greedy tokens agree {agree:.3f}; handoff "
        f"(decode vs fresh prefill, card): max |diff| {h_max:.6f}, argmax "
        f"agrees {float(np.mean(h_agree)):.3f}")
    del params, params_cpu, cache, cache_c
    return {"arch": arch, "layers": cfg.n_layers, "logits_max_abs_diff": d_max,
            "greedy_agree": agree, "handoff_max_abs_diff": h_max,
            "handoff_argmax_agree": float(np.mean(h_agree))}


def ssm_phase(np, torch, smi: str, base_bytes: int) -> dict:
    """Phase 3d: free the card of qwen3-moe, then (a) the two blocks at
    full width, (b) the few-layer stacks, and (c) falcon-mamba-7b, then
    zamba2-2.7b, at full width and depth behind the edge, resume off."""
    left = free_card(torch)
    log(f"phase 3d: {left / 1e9:.4f} GB allocated after phase 3c "
        f"(before phase 3: {base_bytes / 1e9:.4f} GB)")
    if left > base_bytes + (64 << 20):
        raise AssertionError(f"phase 3c left {left - base_bytes} bytes on "
                             "the card")
    t0 = time.perf_counter()
    blocks = ssm_block_check(np, torch)
    free_card(torch)
    stacks = [ssm_layers_check(np, torch, arch) for arch in SSM_FEW_LAYERS]
    free_card(torch)
    edges = []
    for arch, dims, tree in (("falcon-mamba-7b", FALCON_DIMS, falcon_tree),
                             ("zamba2-2.7b", ZAMBA_DIMS, zamba_tree)):
        edges.append(edge_phase(np, torch, smi, edge_argv(arch), dims, tree,
                                resume=False))
        free_card(torch)
    wall = time.perf_counter() - t0
    log(f"phase 3d: {wall:.1f} s")
    return {"blocks": blocks, "stacks": stacks, "edges": edges,
            "wall_s": wall, "allocated_after_phase3c_bytes": left}


# ---------------------------------------------------------------------------
# Phase 3e: training — the train step card against CPU, restart
# equivalence, zamba2-2.7b at full size through the launcher, the example.
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 64
#: (arch, layers, microbatches) of the card-vs-CPU train steps
TRAIN_STEPS = (("yi-9b", 2, 1), ("yi-9b", 2, 2), ("zamba2-2.7b", 6, 1),
               ("falcon-mamba-7b", 2, 1))
#: card against CPU, the same masters and batch: the loss within
#: TRAIN_LOSS_RTOL, the gradients' global norm within TRAIN_GNORM_RTOL, and
#: every leaf's gradient within TRAIN_GRAD_RTOL relative L2 error — the
#: bound the CPU holds the port's gradients to against the reference
#: (tests/test_torch_train_grads.py): bf16 backward passes whose GEMMs
#: round in other places.  adamw_update on the same float32 gradients:
#: params, m and v within ADAM_RTOL of the CPU's, relative to each leaf's
#: largest magnitude (the clip scale comes from each device's own norm).
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RTOL = 1e-3, 2e-2, 5e-2
ADAM_RTOL = 1e-6
#: restart equivalence: tests/test_distribution.py's bound
RESTART_RTOL, RESTART_ATOL = 1e-5, 1e-6
ZAMBA_TRAIN_ARGV = ["--arch", "zamba2-2.7b", "--steps", "6", "--batch", "2",
                    "--seq", "512", "--device", "cuda"]
EXAMPLE_STEPS, EXAMPLE_CKPT_AT, EXAMPLE_RERUN_STEPS = 60, 30, 64


def rel_l2(np, got, want) -> float:
    a = got.detach().double().cpu().numpy()
    b = want.detach().double().cpu().numpy()
    if not np.isfinite(a).all():
        raise AssertionError("non-finite values on the card")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def train_step_check(np, torch, arch: str, layers: int,
                     microbatches: int) -> dict:
    """(a) One train step at full width and ``layers`` layers, B x S =
    2 x 64: ``step.loss_and_grads`` on the card and on the CPU from the
    same float32 masters (drawn on the card, copied), loss, global norm
    and each leaf's gradient held to their bounds; then
    ``optimizer.adamw_update`` on both devices with the CPU's gradients,
    params, m and v held to ADAM_RTOL."""
    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.pytree import tree_map, tree_paths
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    state = step.init_state(11, cfg, device="cuda")
    state_cpu = tree_map(lambda a: a.cpu(), state)
    batch = pipeline.batch_at(pipeline.DataConfig(
        cfg.vocab_size, TRAIN_S, TRAIN_B, seed=12), 0)
    t0 = time.perf_counter()
    loss, grads = step.loss_and_grads(cfg, state["params"], batch,
                                      microbatches)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, grads_c = step.loss_and_grads(cfg, state_cpu["params"], batch,
                                          microbatches)
    cpu_s = time.perf_counter() - t0
    gn, gn_c = float(opt.global_norm(grads)), float(opt.global_norm(grads_c))
    loss, loss_c = float(loss), float(loss_c)
    errs = {"/".join(p): rel_l2(np, g, gc) for (p, g), (_, gc) in
            zip(tree_paths(grads), tree_paths(grads_c))}
    worst = max(errs, key=errs.get)
    if not (np.isfinite(loss) and np.isfinite(gn)) or \
            abs(loss - loss_c) > TRAIN_LOSS_RTOL * abs(loss_c) or \
            abs(gn - gn_c) > TRAIN_GNORM_RTOL * gn_c or \
            errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(
            f"{arch} x{layers} mb{microbatches} train step, card vs CPU: "
            f"loss {loss} vs {loss_c}, grad norm {gn} vs {gn_c}, worst "
            f"leaf {worst} {errs[worst]}")
    ocfg = opt.OptConfig()
    grads_on_card = tree_map(lambda g: g.cuda(), grads_c)
    del grads
    _, state["opt"], _ = opt.adamw_update(ocfg, state["params"],
                                          state["opt"], grads_on_card)
    _, state_cpu["opt"], _ = opt.adamw_update(
        ocfg, state_cpu["params"], state_cpu["opt"], grads_c)
    adam_err = 0.0
    for name in ("params", "m", "v"):
        tree = state["params"] if name == "params" else state["opt"][name]
        tree_c = (state_cpu["params"] if name == "params"
                  else state_cpu["opt"][name])
        for (p, a), (_, b) in zip(tree_paths(tree), tree_paths(tree_c)):
            err = float((a.cpu() - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            if err > ADAM_RTOL:
                raise AssertionError(
                    f"{arch} adamw_update card vs CPU, {name}/"
                    f"{'/'.join(p)}: max |diff| {err} of the leaf's max")
            adam_err = max(adam_err, err)
    if int(state["opt"]["step"]) != 1:
        raise AssertionError("the optimizer step did not advance")
    log(f"{arch} at full width, {layers} layers, microbatches "
        f"{microbatches}, {TRAIN_B} x {TRAIN_S}: loss {loss:.6f} (CPU "
        f"{loss_c:.6f}), grad norm {gn:.6f} (CPU {gn_c:.6f}), worst leaf "
        f"{worst} rel L2 {errs[worst]:.6f}; adamw card vs CPU max rel "
        f"{adam_err:.3g}; card {card_s:.2f} s, CPU {cpu_s:.2f} s")
    del state, state_cpu, grads_c, grads_on_card
    return {"arch": arch, "layers": layers, "microbatches": microbatches,
            "loss": loss, "loss_cpu": loss_c, "grad_norm": gn,
            "grad_norm_cpu": gn_c, "worst_leaf": worst,
            "worst_leaf_rel_l2": errs[worst],
            "median_leaf_rel_l2": float(np.median(list(errs.values()))),
            "adam_max_rel": adam_err, "card_s": card_s, "cpu_s": cpu_s}


def load_example(name: str):
    """A module of ``examples/`` by file name (they are scripts, not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def restart_check(np, torch, tmp: str) -> dict:
    """(b) The 10m preset on the card: 4 steps straight against 2 steps,
    ``checkpoint.save``, ``restore_latest`` and 2 more, every param within
    rtol 1e-5/atol 1e-6 and both optimizer steps at 4."""
    from repro_torch.data import pipeline
    from repro_torch.dist import checkpoint
    from repro_torch.pytree import tree_paths
    from repro_torch.train import step

    cfg = load_example("train_lm_torch").build_config("10m")
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=2, seed=3)
    step_fn = step.make_train_step(cfg)
    direct = step.init_state(0, cfg, device="cuda")
    for i in range(4):
        direct, _ = step_fn(direct, pipeline.batch_at(dcfg, i))
    first = step.init_state(0, cfg, device="cuda")
    for i in range(2):
        first, _ = step_fn(first, pipeline.batch_at(dcfg, i))
    checkpoint.save(tmp, 2, first, process_index=0)
    at, resumed = checkpoint.restore_latest(tmp, first)
    for i in range(at, 4):
        resumed, _ = step_fn(resumed, pipeline.batch_at(dcfg, i))
    if at != 2 or int(direct["opt"]["step"]) != 4 or \
            int(resumed["opt"]["step"]) != 4:
        raise AssertionError(f"restart: restored step {at}, steps "
                             f"{int(direct['opt']['step'])}/"
                             f"{int(resumed['opt']['step'])}")
    d_max = 0.0
    for (p, a), (_, b) in zip(tree_paths(direct["params"]),
                              tree_paths(resumed["params"])):
        d = (a - b).abs()
        if (d > RESTART_ATOL + RESTART_RTOL * b.abs()).any():
            raise AssertionError(f"restart: {'/'.join(p)} differs, max "
                                 f"|diff| {float(d.max())}")
        d_max = max(d_max, float(d.max()))
    log(f"restart equivalence (10m preset, 4 steps vs 2 + checkpoint + "
        f"2): params max |diff| {d_max:.3g}")
    return {"preset": "10m", "params_max_abs_diff": d_max}


def zamba_train_check(np, torch) -> dict:
    """(c) zamba2-2.7b at full width and depth through
    ``repro_torch.launch.train.main``: 6 steps of 2 x 512 tokens, every
    loss and grad norm finite, the optimizer step at 6; the median step
    time after the first, tokens/s, the peak memory and the share of the
    6 N tokens model-FLOP bound at the card's dense bf16 peak."""
    from repro_torch.launch import train
    from repro_torch.models import transformer

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, history = train.main(ZAMBA_TRAIN_ARGV)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    steps = int(state["opt"]["step"])
    n_params = transformer.param_count(state["params"])
    zamba_tree(state["params"])
    if steps != 6 or len(history) != 6 or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
            for h in history):
        raise AssertionError(f"zamba2-2.7b training: step {steps}, "
                             f"history {history}")
    step_s = statistics.median(h["seconds"] for h in history[1:])
    tokens = 2 * 512
    bound_s = 6 * n_params * tokens / h100().peak_flops
    out = {"arch": "zamba2-2.7b", "params": n_params, "batch": 2,
           "seq": 512, "steps": steps, "wall_s": wall,
           "first_step_s": history[0]["seconds"], "median_step_s": step_s,
           "step_s": [h["seconds"] for h in history],
           "tokens_per_s": tokens / step_s, "peak_mem_bytes": peak,
           "model_flop_bound_s": bound_s,
           "model_flop_share": bound_s / step_s,
           "losses": [h["loss"] for h in history],
           "grad_norms": [h["grad_norm"] for h in history]}
    log(f"zamba2-2.7b training ({n_params / 1e9:.3f} B params, 2 x 512): "
        f"first step {history[0]['seconds']:.2f} s, median after "
        f"{step_s:.3f} s, {out['tokens_per_s']:.0f} tokens/s, peak "
        f"{peak / 1e9:.2f} GB, {out['model_flop_share']:.4f} of the "
        f"{bound_s * 1e3:.1f} ms model-FLOP bound; losses "
        f"{[round(x, 4) for x in out['losses']]}")
    out.update(counted_step(torch, state))
    out["step_memory"] = train_step_memory(np, torch, state)
    del state
    return out


def launcher_step():
    """The train step of ``ZAMBA_TRAIN_ARGV``'s launcher (its optimizer
    settings) and the batch of the step after its last: ``(cfg, step,
    batch)``, the batch as numpy arrays."""
    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step

    argv = dict(zip(ZAMBA_TRAIN_ARGV[::2], ZAMBA_TRAIN_ARGV[1::2]))
    b, s = int(argv["--batch"]), int(argv["--seq"])
    cfg = get_arch(argv["--arch"])
    step_fn = step.make_train_step(cfg, opt.OptConfig(
        peak_lr=3e-4, total_steps=max(int(argv["--steps"]), 100)))
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b),
        int(argv["--steps"]))
    return cfg, step_fn, batch


def train_step_memory(np, torch, state) -> dict:
    """(i) of phase 9 (b): one more step of the run above beside
    :func:`counted_step`, its state as the arguments and its batch on
    the card as the dry run's, measured by :func:`step_memory`."""
    _, step_fn, batch = launcher_step()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in batch.items()}
    m = step_memory(torch, step_fn, (state, batch))
    log(f"zamba2-2.7b train step on the card (2 x 512): arguments "
        f"{m['argument_bytes']} B, step peak {m['step_peak_bytes']} B over "
        f"{m['entry_bytes']} B at entry; counted on the card: "
        f"{m['counted_on_card']}")
    return m


def counted_step(torch, state) -> dict:
    """One more step of the run above (step 6, the launcher's optimizer
    and data settings) under ``roofline.jaxpr_cost.step_flops``: the
    FLOPs the card ran, beside ``roofline.analysis.model_flops`` for
    2 x 512 tokens.  Phase 8 reports them."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import analysis, jaxpr_cost

    cfg, step_fn, batch = launcher_step()
    b, s = batch["tokens"].shape
    t0 = time.perf_counter()
    flops = jaxpr_cost.step_flops(step_fn, state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    model = analysis.model_flops(cfg, ShapeConfig("zamba2_2x512", s, b,
                                                  "train"), 1)
    if not flops > 0:
        raise AssertionError(f"counted step FLOPs {flops}")
    return {"step_flops": flops, "model_flops": model,
            "step_over_model_flops": flops / model,
            "counted_step_s": counted_s}


def example_check(np, torch, tmp: str) -> dict:
    """(d) ``examples/train_lm_torch.py --preset 100m``: 60 steps of 4 x
    256 with a checkpoint at step 30; the loss must go DOWN; a rerun to 64
    steps must restore the checkpoint published at step 60."""
    import contextlib
    import io
    example = load_example("train_lm_torch")
    argv = ["--preset", "100m", "--batch", "4", "--seq", "256",
            "--ckpt-dir", tmp, "--ckpt-every", str(EXAMPLE_CKPT_AT),
            "--device", "cuda"]
    runs = []
    for steps in (EXAMPLE_STEPS, EXAMPLE_RERUN_STEPS):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            first, last = example.main(argv + ["--steps", str(steps)])
        runs.append((out.getvalue(), time.perf_counter() - t0, first, last))
    text, wall, first, last = runs[0]
    published = [f"step_{s}" for s in (EXAMPLE_CKPT_AT, EXAMPLE_STEPS)]
    if "DOWN" not in text or not last < first or \
            not all(f"published {tmp}/100m/{p}" in text for p in published):
        raise AssertionError(f"train_lm_torch 100m run:\n{text}")
    text2, wall2, _, _ = runs[1]
    if f"restored checkpoint at step {EXAMPLE_STEPS}" not in text2:
        raise AssertionError(f"train_lm_torch rerun:\n{text2}")
    log(f"train_lm_torch 100m: loss {first:.4f} -> {last:.4f} over "
        f"{EXAMPLE_STEPS} steps in {wall:.1f} s; rerun restored step "
        f"{EXAMPLE_STEPS} and ran to {EXAMPLE_RERUN_STEPS} in {wall2:.1f} s")
    return {"preset": "100m", "steps": EXAMPLE_STEPS, "first_loss": first,
            "last_loss": last, "wall_s": wall, "rerun_wall_s": wall2}


def train_phase(np, torch, smi: str, base_bytes: int) -> dict:
    """Phase 3e: free the card of phase 3d, then (a) train steps card
    against CPU, (b) restart equivalence, (c) zamba2-2.7b trained at full
    size, (d) the 100m example with checkpoint and restart."""
    import shutil
    import tempfile

    left = free_card(torch)
    log(f"phase 3e: {left / 1e9:.4f} GB allocated after phase 3d "
        f"(before phase 3: {base_bytes / 1e9:.4f} GB)")
    if left > base_bytes + (64 << 20):
        raise AssertionError(f"phase 3d left {left - base_bytes} bytes on "
                             "the card")
    t0 = time.perf_counter()
    steps = []
    for arch, layers, mb in TRAIN_STEPS:
        steps.append(train_step_check(np, torch, arch, layers, mb))
        free_card(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        restart = restart_check(np, torch, tmp + "/restart")
        free_card(torch)
        zamba = zamba_train_check(np, torch)
        free_card(torch)
        example = example_check(np, torch, tmp + "/example")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_card(torch)
    wall = time.perf_counter() - t0
    log(f"phase 3e: {wall:.1f} s")
    report = {"steps": steps, "restart": restart, "zamba2_train": zamba,
              "example": example, "wall_s": wall, "card": smi,
              "allocated_after_phase3d_bytes": left}
    print(json.dumps({"training": report}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 3f: training over a torch.distributed mesh — two ranks on cuda:0.
# ---------------------------------------------------------------------------

MESH_CHILD = "--mesh-child"    # argv[1] of a rank this script spawns
MESH_DEV = "cuda:0"            # both ranks share the one card
MESH_WORLD = 2
MESH_TIMEOUT_S = 480
MESH_BATCH, MESH_SEQ, MESH_SEED = 2, 512, 13
#: (b): zamba2-2.7b at full width and one layer group (6 layers; 12 until
#: phase 3g and 9 (d) needed the script's time), on a (2, 1) mesh
MESH_ARCH, MESH_LAYERS, MESH_SHAPE = "zamba2-2.7b", 6, (2, 1)
#: (c): (b)'s configuration, then yi-9b at full width and 2 layers (the
#: vocabulary split over model, 4 KV heads over 2), on a (1, 2) mesh
MP_SHAPE, MP_ARCH, MP_LAYERS = (1, 2), "yi-9b", 2
#: the collectives the probe runs on a two-rank gloo group of cuda:0
#: tensors: raw c10d calls, then the DTensor redistributions they carry
PROBES = ("all_reduce", "broadcast", "all_gather_into_tensor", "all_gather",
          "reduce_scatter_tensor", "all_to_all_single", "barrier",
          "all_gather_into_tensor_of_a_row", "dtensor_partial_to_replicate",
          "dtensor_partial_to_shard", "dtensor_shard0_to_shard1")
#: probes that kill both ranks with SIGSEGV on the card's torch (2.11,
#: ROADMAP Queue 3 item 18): the functional all-gather DTensor's Shard ->
#: Replicate runs, so every gather and cut on the serving path and in
#: the train step is a raw one (``dist/sharding.py``).  Each runs in a
#: pair of its own.
PROBES_FATAL = ("functional_all_gather", "dtensor_shard_to_replicate")
#: what (b) and (c) need: the gradient all-reduce (a Partial ->
#: Replicate), and (c) the raw all-gather
MESH_NEEDS = ("all_reduce", "dtensor_partial_to_replicate",
              "all_gather_into_tensor")


def start_ranks(kind: str, workdir: str) -> list:
    """MESH_WORLD child processes running ``kind`` (this script with
    ``MESH_CHILD kind rank port workdir``); returns ``(process, log)``
    pairs."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ranks = []
    for r in range(MESH_WORLD):
        log_path = pathlib.Path(workdir) / f"{kind}{r}.log"
        with open(log_path, "w") as log_f:
            ranks.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), MESH_CHILD,
                 kind, str(r), str(port), workdir],
                stdout=log_f, stderr=subprocess.STDOUT), log_path))
    return ranks


def wait_ranks(ranks: list) -> None:
    """Wait for every child until MESH_TIMEOUT_S; kill what is left."""
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p, _ in ranks:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _ in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()


def result_of(kind: str, workdir: str, r: int) -> dict:
    return json.loads((pathlib.Path(workdir) / f"{kind}{r}.json")
                      .read_text())


def spawn_ranks(kind: str, workdir: str) -> list:
    """Run ``kind`` on MESH_WORLD ranks; a failed or hung child fails the
    phase.  Returns each rank's JSON result."""
    ranks = start_ranks(kind, workdir)
    wait_ranks(ranks)
    for r, (p, log_path) in enumerate(ranks):
        if p.returncode != 0:
            raise AssertionError(f"phase 3f {kind} rank {r} exited "
                                 f"{p.returncode}:\n"
                                 f"{log_path.read_text()[-6000:]}")
    return [result_of(kind, workdir, r) for r in range(MESH_WORLD)]


def probe_collectives(workdir: str) -> dict:
    """(a) PROBES one after another on one pair of ranks, and each of
    PROBES_FATAL on a pair of its own, all pairs at once: probe name ->
    "ok", "wrong values", the error's first line, or the exit codes of
    ranks that died."""
    pairs = {f"probe:{name}": (name,) for name in PROBES_FATAL}
    pairs["probe"] = PROBES
    ranks_of = {kind: start_ranks(kind, workdir) for kind in pairs}
    for ranks in ranks_of.values():
        wait_ranks(ranks)
    out = {}
    for kind, names in pairs.items():
        codes = [p.returncode for p, _ in ranks_of[kind]]
        got = [None if codes[r] else result_of(kind, workdir, r)
               for r in range(MESH_WORLD)]
        for name in names:
            if any(codes):
                out[name] = f"rank exit codes {codes}"
            elif got[0][name] != got[1][name]:
                out[name] = f"ranks differ: {got[0][name]}, {got[1][name]}"
            else:
                out[name] = got[0][name]
    return out


def join_group(torch, rank: int, port: int) -> None:
    import datetime
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=MESH_WORLD, timeout=datetime.timedelta(seconds=300))


def probe_child(np, torch, rank: int, port: int, names: list) -> dict:
    """(a) Probes of a two-rank gloo group on tensors of the one card, in
    turn: each one's values checked, or its error's first line."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dist = torch.distributed
    join_group(torch, rank, port)
    dev = torch.device(MESH_DEV)
    ar = lambda *a: torch.arange(*a, dtype=torch.float32, device=dev)
    x = ar(4) + 4 * rank
    full = ar(8).reshape(2, 4)
    dm = init_device_mesh(dev.type, (MESH_WORLD,), mesh_dim_names=("data",))

    def redistribute(local, src, dst):
        return DTensor.from_local(local, dm, [src], run_check=False) \
            .redistribute(dm, [dst]).to_local()

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return t, ar(4) * 2 + 4

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=0)
        return t, ar(4)

    def all_gather_into_tensor():
        t = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(t, x)
        return t, ar(8)

    def all_gather():
        ts = [torch.empty(4, device=dev) for _ in range(MESH_WORLD)]
        dist.all_gather(ts, x)
        return torch.cat(ts), ar(8)

    def reduce_scatter_tensor():
        t = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(t, ar(8) + rank)
        return t, (ar(8) * 2 + 1)[4 * rank:4 * rank + 4]

    def all_to_all_single():
        t = torch.empty(8, device=dev)
        dist.all_to_all_single(t, ar(8) + 8 * rank)
        return t, torch.cat([ar(4) + 4 * rank, ar(4) + 4 * rank + 8])

    def barrier():
        dist.barrier()
        return x, x

    def all_gather_into_tensor_of_a_row():       # DTensor's operand
        t = torch.empty(2, 4, device=dev)
        dist.all_gather_into_tensor(t, full[rank:rank + 1])
        return t, full

    def functional_all_gather():                 # DTensor's call
        from torch.distributed import _functional_collectives as funcol
        return funcol.all_gather_tensor(full[rank:rank + 1], 0,
                                        dist.group.WORLD), full

    def dtensor_shard_to_replicate():
        return redistribute(full[rank:rank + 1], Shard(0), Replicate()), full

    def dtensor_partial_to_replicate():
        return redistribute(full.clone(), Partial(), Replicate()), full * 2

    def dtensor_partial_to_shard():
        return (redistribute(full.clone(), Partial(), Shard(0)),
                full[rank:rank + 1] * 2)

    def dtensor_shard0_to_shard1():
        return (redistribute(full[rank:rank + 1], Shard(0), Shard(1)),
                full[:, 2 * rank:2 * rank + 2])

    probes, out = locals(), {}
    for name in names:
        try:
            got, want = probes[name]()
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(got, want) else "wrong values"
        except Exception as e:       # the answer is what the group refuses
            out[name] = (f"{type(e).__name__}: "
                         f"{str(e).strip().splitlines()[0][:160]}")
    dist.destroy_process_group()
    return out


def one_process_step(torch, cfg, dcfg, dev) -> dict:
    """Rank 0's one-process step of ``cfg`` on the card (plain tensors)
    from ``init_state(MESH_SEED)`` on ``dcfg``'s batch 0: its seconds,
    metrics, the state after it and the initial params, on the host; the
    card is freed after."""
    from repro_torch.data import pipeline
    from repro_torch.pytree import tree_paths
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step

    state = step.init_state(MESH_SEED, cfg, device=dev)
    p0 = {p: v.cpu() for p, v in tree_paths(state["params"])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step.make_train_step(cfg, opt.OptConfig())(
        state, pipeline.batch_at(dcfg, 0))
    torch.cuda.synchronize()
    one = {"seconds": time.perf_counter() - t0,
           "metrics": {k: float(v) for k, v in m.items()},
           "state": {p: v.cpu() for p, v in tree_paths(state)}, "p0": p0}
    del state, m
    free_card(torch)
    return one


def mesh_step_check(np, torch, rank: int, cfg, dcfg, shape, one,
                    ckpt: str, guarded: bool) -> dict:
    """One placed step of ``cfg`` over a ``("data", "model")`` mesh of
    ``shape`` from ``init_state(MESH_SEED, device_mesh=)``, on the placed
    global batch 0, its collectives counted (refused where they would
    gather functionally, with ``guarded``); rank 0 holds the metrics and
    every gathered leaf to the one-process step ``one`` by (b)'s bounds;
    the placed state is saved to ``ckpt`` (unless None) on every rank and
    restored by rank 0 bit for bit; a second step is timed.  Returns
    this rank's record; the card is freed after."""
    import shutil

    from repro_torch.data import pipeline
    from repro_torch.dist import checkpoint, sharding
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.pytree import tree_paths
    from repro_torch.roofline.analysis import (CollectiveCounter,
                                               NoFunctionalGather)
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step

    dev = torch.device(MESH_DEV)
    ocfg = opt.OptConfig()
    mesh = Mesh(("data", "model"), shape)
    dm = device_mesh(mesh, dev.type)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    counter = NoFunctionalGather if guarded else CollectiveCounter

    def placed_batch(i):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in pipeline.batch_at(dcfg, i).items()}
        return sharding.place(b, sharding.batch_specs(b, dm), dm)

    state = step.init_state(MESH_SEED, cfg, device=dev, device_mesh=dm)
    step_fn = step.make_train_step(cfg, ocfg)
    comms = counter()
    batch = placed_batch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with comms:
        state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in m.items()}
    out = {"rank": rank, "arch": cfg.name,
           "mesh": dict(zip(mesh.axis_names, mesh.shape)),
           "layers": cfg.n_layers, "metrics": metrics,
           "first_step_s": first_s, "collectives": comms.counts,
           "collective_bytes": comms.nbytes,
           "params": sum(v.numel() for _, v in tree_paths(state["params"])),
           "local_state_bytes": sum(
               v.to_local().numel() * v.to_local().element_size()
               for _, v in tree_paths(state))}
    if rank == 0:
        want = one["metrics"]
        if abs(metrics["loss"] - want["loss"]) > 1e-3 * abs(want["loss"]) or \
                abs(metrics["grad_norm"] - want["grad_norm"]) > \
                2e-2 * want["grad_norm"] or \
                abs(metrics["lr"] - want["lr"]) > 1e-6 * want["lr"]:
            raise AssertionError(f"{cfg.name} mesh step {metrics} against "
                                 f"the one-process step {want}")
        out.update(one_process_s=one["seconds"], one_process=want)
    t0 = time.perf_counter()
    if ckpt is not None:
        checkpoint.save(ckpt, 1, state)           # every rank
        out["save_s"] = time.perf_counter() - t0
        if rank == 0:
            _, restored = checkpoint.restore_latest(ckpt, state)
            restored = dict(tree_paths(restored))
    t0 = time.perf_counter()
    worst = {"m": 0.0, "v": 0.0, "params": 0.0}
    lr, wd = metrics["lr"], ocfg.weight_decay
    for path, leaf in tree_paths(state):
        full = sharding.full(leaf)                # every rank joins
        if rank != 0:
            continue
        if ckpt is not None and not torch.equal(restored.pop(path), full):
            raise AssertionError(f"{cfg.name} {'/'.join(path)}: the "
                                 "checkpoint saved on two ranks is not "
                                 "restored bit for bit")
        if path == ("opt", "step"):
            continue
        ref = one["state"][path].to(dev)
        name = path[1] if path[0] == "opt" else "params"
        if name == "params":
            reach = 2 * lr * (1 + wd * one["p0"][path[1:]].to(dev).abs()) \
                + 1e-7
            err = float(((full - ref).abs() / reach).max())
            limit = 1.0
        else:
            err = float(torch.linalg.vector_norm(full - ref) /
                        torch.linalg.vector_norm(ref).clamp_min(1e-30))
            limit = 5e-2 if name == "m" else 1e-1
        if not err <= limit:
            raise AssertionError(f"{cfg.name} {'/'.join(path)}: {err} of "
                                 "its bound against the one-process step")
        worst[name] = max(worst[name], err)
    out["check_s"] = time.perf_counter() - t0
    if rank == 0:
        restored = None
        out["worst_against_one_process"] = worst
        if ckpt is not None:
            shutil.rmtree(ckpt, ignore_errors=True)
    batch = placed_batch(1)
    torch.distributed.barrier()                   # rank 0 compared last
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counter():
        state, m = step_fn(state, batch)
        loss2 = float(m["loss"])
    torch.cuda.synchronize()
    out.update(second_step_s=time.perf_counter() - t0, second_loss=loss2,
               peak_bytes=torch.cuda.max_memory_allocated())
    if not np.isfinite(loss2):
        raise AssertionError(f"{cfg.name} second step loss {loss2}")
    del state, m, batch
    free_card(torch)
    return out


def train_child(np, torch, rank: int, port: int, workdir: str) -> dict:
    """(b), then (c), on one rank.  Rank 0 first runs the one-process
    step of (b)'s configuration, seed and global batch on the card and
    keeps it on the host (:func:`one_process_step`); both ranks join the
    group and run (b) on MESH_SHAPE, then (c) on MP_SHAPE: (b)'s
    configuration held to the same one-process step, its checkpoint
    too, then MP_ARCH (rank 0 runs its one-process step first, the other
    rank waiting; not saved: 10.4 GB of state took 154 s to save on the
    H100's host), each step under ``analysis.NoFunctionalGather``
    (:func:`mesh_step_check`)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline

    dev = torch.device(MESH_DEV)
    cfg = dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_LAYERS)
    dcfg = pipeline.DataConfig(cfg.vocab_size, MESH_SEQ, MESH_BATCH,
                               seed=MESH_SEED)
    one = one_process_step(torch, cfg, dcfg, dev) if rank == 0 else None
    join_group(torch, rank, port)
    ckpt = str(pathlib.Path(workdir) / "ckpt")
    out = mesh_step_check(np, torch, rank, cfg, dcfg, MESH_SHAPE, one,
                          ckpt + "_dp", guarded=False)
    t0 = time.perf_counter()
    mp = {MESH_ARCH: mesh_step_check(np, torch, rank, cfg, dcfg, MP_SHAPE,
                                     one, ckpt + "_mp", guarded=True)}
    del one
    cfg = dataclasses.replace(get_arch(MP_ARCH), n_layers=MP_LAYERS)
    dcfg = pipeline.DataConfig(cfg.vocab_size, MESH_SEQ, MESH_BATCH,
                               seed=MESH_SEED)
    one = one_process_step(torch, cfg, dcfg, dev) if rank == 0 else None
    torch.distributed.barrier()
    mp[MP_ARCH] = mesh_step_check(np, torch, rank, cfg, dcfg, MP_SHAPE, one,
                                  None, guarded=True)
    out["model_parallel"] = mp
    out["model_parallel_s"] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    return out


def mesh_child(argv: list) -> int:
    """A rank of phase 3f: ``kind rank port workdir``; writes its result
    to ``workdir/{kind}{rank}.json``."""
    import numpy as np
    import torch
    kind, rank, port, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(torch.device(MESH_DEV))
    if kind.startswith("probe"):
        out = probe_child(np, torch, rank, port,
                          kind.split(":")[1:] or PROBES)
    else:
        out = train_child(np, torch, rank, port, workdir)
    (pathlib.Path(workdir) / f"{kind}{rank}.json").write_text(
        json.dumps(out))
    return 0


def mesh_step_line(part: str, ranks: list) -> str:
    """One log line of a part's placed step: both ranks' records, rank 0
    holding the one-process step's numbers."""
    r0 = ranks[0]
    if r0["metrics"] != ranks[1]["metrics"]:
        raise AssertionError(f"{part}: the ranks' metrics differ: "
                             f"{[r['metrics'] for r in ranks]}")
    return (
        f"phase 3f {part} {r0['arch']} x{r0['layers']} on {r0['mesh']}, "
        f"{MESH_BATCH} x {MESH_SEQ}: loss {r0['metrics']['loss']:.6f} (one "
        f"process {r0['one_process']['loss']:.6f}), grad norm "
        f"{r0['metrics']['grad_norm']:.6f} "
        f"({r0['one_process']['grad_norm']:.6f}); worst against one "
        f"process {r0['worst_against_one_process']}; steps "
        f"{[round(r['first_step_s'], 2) for r in ranks]} s cold, "
        f"{[round(r['second_step_s'], 2) for r in ranks]} s warm (one "
        f"process {r0['one_process_s']:.2f} s); "
        + (f"save {[round(r['save_s'], 2) for r in ranks]} s, restored bit "
           "for bit; " if "save_s" in r0 else "not saved; ")
        + f"held in {r0['check_s']:.2f} s; peak "
        f"{[round(r['peak_bytes'] / 1e9, 2) for r in ranks]} GB; "
        f"collectives a rank {[r['collectives'] for r in ranks]}, "
        f"{[r['collective_bytes'] for r in ranks]} bytes")


def mesh_phase(np, torch, smi: str, base_bytes: int) -> dict:
    """Phase 3f: free the card of phase 3e, then (a) the collective probe,
    (b) the data-parallel zamba2-2.7b steps and (c) the model-parallel
    zamba2-2.7b and yi-9b steps, each on two ranks of ``cuda:0`` spawned
    as child processes ((b) and (c) in one pair)."""
    import shutil
    import tempfile

    left = free_card(torch)
    log(f"phase 3f: {left / 1e9:.4f} GB allocated after phase 3e "
        f"(before phase 3: {base_bytes / 1e9:.4f} GB)")
    if left > base_bytes + (64 << 20):
        raise AssertionError(f"phase 3e left {left - base_bytes} bytes on "
                             "the card")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        probe = probe_collectives(tmp)
        log(f"phase 3f (a) gloo on {MESH_DEV} tensors: {probe}")
        if any(probe[name] != "ok" for name in MESH_NEEDS):
            raise AssertionError(f"(b) and (c) need {MESH_NEEDS}: {probe}")
        ranks = spawn_ranks("dp", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(mesh_step_line("(b)", ranks))
    mp = {arch: [r["model_parallel"][arch] for r in ranks]
          for arch in (MESH_ARCH, MP_ARCH)}
    for arch, mp_ranks in mp.items():
        log(mesh_step_line("(c)", mp_ranks))
    mp_s = [r["model_parallel_s"] for r in ranks]
    log(f"phase 3f (c): {[round(t, 1) for t in mp_s]} s a rank")
    wall = time.perf_counter() - t0
    log(f"phase 3f: {wall:.1f} s")
    report = {"probe": probe,
              "data_parallel": [{k: v for k, v in r.items()
                                 if not k.startswith("model_parallel")}
                                for r in ranks],
              "model_parallel": mp, "model_parallel_s": mp_s,
              "wall_s": wall, "card": smi}
    print(json.dumps({"mesh_training": report}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 3g: serving over a torch.distributed mesh, the launchers under
# torchrun on two ranks of the card.
# ---------------------------------------------------------------------------

TORCHRUN_CHILD = "--torchrun-child"   # argv[1] of a rank torchrun starts
#: (a): phase 3's launcher and requests on a (2, 1) mesh
MESH_SERVE_ARGV = SERVE_ARGV + ["--mesh", "host"]
#: (b): qwen3-moe-30b-a3b at full width and this depth behind the edge
#: (8 until phase 3g (c) and (d) needed the script's time)
MESH_MOE_LAYERS = 4
#: (b)'s requests are two rows each, one on each rank (data
#: parallelism).  A rank computes its row as one process computes that
#: row alone, so the tokens are held to a one-process request loop that
#: serves each request's rows one at a time at B = 1, with the batch's
#: lookups, resume run and admissions (:func:`edge_loop`).  A one-process
#: loop at B = 2 runs other GEMM shapes, and at eight MoE layers of random
#: bf16 weights that reroutes tokens past the margin rule; the phase
#: measures and prints that difference, and the run-to-run spread of the
#: B = 1 loop.
MESH_EDGE_ROWS = 2
#: (d): zamba2-2.7b at full width and one layer group (6 layers, as
#: phase 3f's), resume off, phase 3's requests on a (1, 2) mesh
MP_SSM_ARCH, MP_SSM_LAYERS = "zamba2-2.7b", 6
MP_SSM_ARGV = ["--arch", MP_SSM_ARCH] + SERVE_ARGV[2:]
MESH_EDGE_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--device", "cuda",
                  "--host", "127.0.0.1", "--port", "0", "--prompt-len", "96",
                  "--decode-tokens", "8", "--admit-after-reads", "0",
                  "--n-shards", "4", "--n-workers", "1",
                  "--batch-window-ms", "0"]


class RecordedGaps:
    """Every greedy step's top-1/top-2 logit gap, row by row: the margin
    rule's reference.  :meth:`record` is the launchers' ``on_logits``
    (called once per emitted token, before its argmax)."""

    def __init__(self, np):
        self.np, self.gaps = np, []

    def record(self, logits) -> None:
        self.gaps.append(top2_gap(self.np, logits.float().cpu().numpy()))

    def take(self):
        """The (B, steps) gaps recorded since the last take."""
        g, self.gaps = self.gaps, []
        return self.np.stack(g, axis=1)

    def per_request(self, n_tokens: int) -> list:
        """(B, n_tokens) gaps of each request, in serving order."""
        g = self.gaps
        return [self.np.stack(g[i:i + n_tokens], axis=1)
                for i in range(0, len(g), n_tokens)]


def edge_moe_config():
    """qwen3-moe-30b-a3b at full width and MESH_MOE_LAYERS layers, the
    config phase 3g (b) passes the edge."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("qwen3-moe-30b-a3b"),
                               n_layers=MESH_MOE_LAYERS)


def start_torchrun(args: list, log_path) -> subprocess.Popen:
    """``torch.distributed.run --standalone`` of MESH_WORLD ranks of this
    script with ``TORCHRUN_CHILD args``, its output to ``log_path``."""
    with open(log_path, "w") as log_f:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={MESH_WORLD}", str(ROOT / "chip_smoke.py"),
             TORCHRUN_CHILD, *args], stdout=log_f, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))


def serve_child(np, torch, workdir: str, part: str, shape,
                ssm: bool = False) -> dict:
    """(a), (c) One rank: ``launch/serve.serve`` with MESH_SERVE_ARGV on a
    ``("data", "model")`` mesh of ``shape`` (the placed model, the rank's
    own index replica, the hit masks checked across the ranks), its
    records, multi-set launches, collectives and peak memory; rank 0
    also the gathered last-token logits of a full prefill of the last
    batch (``logits_{part}.npy``; its seconds, and a decode token's,
    beside).  (d) ``ssm``:
    MP_SSM_ARGV at MP_SSM_LAYERS layers, and instead of the logits one
    decode step after a prefill of the last batch, its collectives
    counted, then a second step timed."""
    from repro_torch.dist import sharding
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_leaves
    from repro_torch.roofline.analysis import CollectiveCounter
    from repro_torch.serve.step import greedy

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    argv = MP_SSM_ARGV + ["--mesh", "host"] if ssm else MESH_SERVE_ARGV
    with CollectiveCounter() as comms:
        run = serve.serve(serve.parse_args(argv),
                          mesh=Mesh(("data", "model"), shape),
                          cfg=mp_ssm_config() if ssm else None)
    launches = read_counts()["xam_search_multiset"]
    idx, eng = run.index, run.engine
    toks = run.batches[-1]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    extra = {}
    if ssm:
        logits, cache = transformer.prefill(
            run.params, run.cfg, {"tokens": toks},
            toks.shape[1] + SSM_DECODE)
        nxt = greedy(logits)
        with CollectiveCounter() as step:
            logits, cache = transformer.decode_step(
                run.params, run.cfg, nxt, cache, toks.shape[1])
        _, step_s = timed(lambda: transformer.decode_step(
            run.params, run.cfg, greedy(logits), cache, toks.shape[1] + 1))
        extra = {"step_collectives": step.counts,
                 "step_collective_bytes": step.nbytes,
                 "decode_step_s": step_s}
    else:
        full, prefill_s = timed(lambda: eng.prefill(toks, None))
        logits = sharding.full(full.state["logits"]).float().cpu().numpy()
        if run.rank == 0:
            np.save(pathlib.Path(workdir) / f"logits_{part}.npy", logits)
        _, decode_s = timed(lambda: eng.decode(full, 2))
        extra = {"prefill_s": prefill_s, "decode_step_s": decode_s / 2}
    out = {"rank": run.rank, "seconds": run.seconds, **extra,
           "records": [[r.chunks, r.hit_chunks, r.resumed_chunks,
                        int(r.admitted), r.decoded.tolist()]
                       for r in run.records],
           "launches": launches, "searches": idx.stats.searches,
           "admissions": idx.stats.admissions,
           "resumed_chunks": 0 if eng is None else eng.resumed_chunks,
           "collectives": comms.counts, "collective_bytes": comms.nbytes,
           "local_param_bytes": sum(
               t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(run.params)),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    return out


def httpd_child(np, torch, workdir: str) -> dict:
    """(b) One rank: ``launch/httpd.main`` with MESH_EDGE_ARGV and
    ``--mesh host`` at MESH_MOE_LAYERS layers (process 0 binds the
    socket), until the drain; its multi-set launches and peak memory."""
    from repro_torch.launch import httpd
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    httpd.main(MESH_EDGE_ARGV + ["--mesh", "host"], cfg=edge_moe_config())
    return {"rank": torch.distributed.get_rank(),
            "launches": read_counts()["xam_search_multiset"],
            "peak_bytes": torch.cuda.max_memory_allocated()}


#: the serve launcher's parts of phase 3g, run in turn by the ranks of
#: one torchrun: (a) on (2, 1), (c) and (d) on (1, 2)
SERVE_PARTS = {"serve": {"shape": (MESH_WORLD, 1)},
               "serve_mp": {"shape": (1, MESH_WORLD)},
               "serve_ssm": {"shape": (1, MESH_WORLD), "ssm": True}}


def torchrun_child(argv: list) -> int:
    """A rank torchrun started for phase 3g: ``kind workdir``, ``kind``
    ``httpd`` or ``serve`` (every part of SERVE_PARTS in turn, the card
    freed between them); writes each part's result to
    ``workdir/{part}{rank}.json``."""
    import numpy as np
    import torch
    kind, workdir = argv
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    parts = ({"httpd": lambda: httpd_child(np, torch, workdir)}
             if kind == "httpd" else
             {part: functools.partial(serve_child, np, torch, workdir, part,
                                      **kw)
              for part, kw in SERVE_PARTS.items()})
    for part, child in parts.items():
        t0 = time.perf_counter()
        out = child()
        out["part_s"] = time.perf_counter() - t0
        (pathlib.Path(workdir) / f"{part}{out['rank']}.json").write_text(
            json.dumps(out))
        del out
        free_card(torch)
    torch.distributed.destroy_process_group()
    return 0


def wait_torchrun(proc, log_path) -> str:
    """Wait for a torchrun until MESH_TIMEOUT_S (kill it past that);
    returns its output."""
    try:
        proc.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return pathlib.Path(log_path).read_text()


def serve_ranks(workdir: str) -> None:
    """(a), (c), (d): one torchrun of MESH_WORLD ranks running every part
    of SERVE_PARTS; a failed or hung rank fails the phase."""
    log_path = pathlib.Path(workdir) / "serve.log"
    proc = start_torchrun(["serve", workdir], log_path)
    text = wait_torchrun(proc, log_path)
    if proc.returncode != 0:
        raise AssertionError(f"phase 3g serve torchrun exited "
                             f"{proc.returncode}:\n{text[-6000:]}")


def mesh_serve_check(np, torch, one: dict, workdir: str,
                     kind: str = "serve") -> dict:
    """(a) ``launch/serve.py --mesh host`` with phase 3's arguments
    (``kind`` ``serve_mp``: the (1, 2) mesh of (c); ``serve_ssm``: (d)),
    its ranks' results (:func:`serve_ranks`): both ranks' records equal;
    hits, resumed chunks and admissions ``one``'s (phase 3's); greedy
    tokens under the margin rule with its gaps; a full prefill of the
    last batch within the 48-layer ceilings of phase 3's, or for (d) a
    decode step's all-gather bytes the activation figure; each rank
    launched the multi-set search once per lookup."""
    ranks = [result_of(kind, workdir, r) for r in range(MESH_WORLD)]
    if any(ranks[r]["records"] != ranks[0]["records"]
           for r in range(1, MESH_WORLD)):
        raise AssertionError("the ranks' records differ")
    got, want = ranks[0]["records"], one["records"]
    if [g[:4] for g in got] != [w[:4] for w in want] or \
            ranks[0]["admissions"] != one["admissions"]:
        raise AssertionError(f"mesh records {[g[:4] for g in got]}, "
                             f"admissions {ranks[0]['admissions']}; one "
                             f"process {[w[:4] for w in want]}, "
                             f"{one['admissions']}")
    for g, w, gap in zip(got, want, one["gaps"]):
        if not greedy_margin_agree(np.array(g[4]), np.array(w[4]),
                                   np.array(gap)):
            raise AssertionError(f"mesh tokens {g[4]} against {w[4]} "
                                 f"(gaps {gap})")
    if kind == "serve_ssm":
        rows = int(MP_SSM_ARGV[MP_SSM_ARGV.index("--batch") + 1])
        figure = ssm_step_gather_bytes(mp_ssm_config(), rows)
        d_max = outside = None
        for r in ranks:
            if r["step_collective_bytes"]["all-gather"] != figure:
                raise AssertionError(
                    f"rank {r['rank']}: a decode step gathered "
                    f"{r['step_collective_bytes']} bytes, not the "
                    f"activation figure {figure}")
    else:
        a = np.load(pathlib.Path(workdir) / f"logits_{kind}.npy")
        b = one["logits_full_last"]
        d_max = float(np.abs(a - b).max())
        outside = float((np.abs(a - b) > ATOL + RTOL * np.abs(b)).mean())
        if d_max > DEEP_MAX_ABS or outside > DEEP_MAX_OUTSIDE:
            raise AssertionError(f"full prefill over the mesh against one "
                                 f"process: max |diff| {d_max}, {outside} "
                                 "outside rtol/atol")
    for r in ranks:
        if r["launches"] != r["searches"] or r["launches"] <= 0:
            raise AssertionError(f"rank {r['rank']}: {r['launches']} "
                                 f"multi-set launches, {r['searches']} "
                                 "searches")
    tokens_equal = float(np.mean([np.array_equal(g[4], w[4])
                                  for g, w in zip(got, want)]))
    if kind == "serve_ssm":
        held = (f"decode step all-gather bytes a rank "
                f"{[r['step_collective_bytes']['all-gather'] for r in ranks]}"
                f" (activation figure {figure}; all collectives "
                f"{ranks[0]['step_collective_bytes']}), step "
                f"{[round(r['decode_step_s'], 4) for r in ranks]} s")
        what = f"{MP_SSM_ARCH} x{MP_SSM_LAYERS}"
    else:
        held = (f"last batch full prefill max |diff| {d_max:.6f}, "
                f"{outside:.5f} outside, "
                f"{[round(r['prefill_s'], 4) for r in ranks]} s; decode "
                f"{[round(r['decode_step_s'], 4) for r in ranks]} s a token")
        what = "yi-9b x48"
    log(f"phase 3g {kind} {what}: records equal on both ranks "
        f"and to one process ({[g[:4] for g in got]}), requests' tokens "
        f"equal {tokens_equal:.3f}; {held}; serve loop "
        f"{[round(r['seconds'], 2) for r in ranks]} s, part "
        f"{[round(r['part_s'], 1) for r in ranks]} s (one process "
        f"{one['seconds']:.2f}); multi-set launches a rank "
        f"{[r['launches'] for r in ranks]}; collectives a rank "
        f"{ranks[0]['collectives']}, {ranks[0]['collective_bytes']} bytes; "
        f"local params {[round(r['local_param_bytes'] / 1e9, 2) for r in ranks]}"
        f" GB, peak {[round(r['peak_bytes'] / 1e9, 2) for r in ranks]} GB")
    return {"ranks": [{k: v for k, v in r.items() if k != "records"}
                      for r in ranks], "tokens_equal": tokens_equal,
            "prefill_max_abs_diff": d_max, "prefill_outside_tol": outside,
            "one_process_s": one["seconds"]}


def edge_requests(np, vocab: int, rows: int) -> list:
    """phase 3b's requests with ``rows`` rows: 96 tokens a row sharing a
    48-token prefix."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, vocab, 48)
    return [np.concatenate([np.tile(prefix, (rows, 1)), rng.integers(
        1, vocab, (rows, 48))], axis=1).astype(np.int32)
        for _ in range(EDGE_REQUESTS)]


def edge_loop(np, cfg, params, batches, rows_alone: bool):
    """The edge's request loop in one process, with its index config
    and inline admission, over ``batches``: whole batches, or
    (``rows_alone``) each batch's rows prefilled and decoded one at a time
    at B = 1 with the batch's common resume run, as each rank of a
    data-parallel mesh computes them.  Returns (records, per-request
    (B, decode) top-2 gaps, seconds)."""
    from repro_torch.launch import httpd, serve
    from repro_torch.serve.admit_queue import AdmitQueue
    from repro_torch.serve.kv_index import KVSlabStore, MonarchKVIndex
    from repro_torch.serve.resume import PrefillResult, PrefixResumeEngine

    args = httpd.build_parser().parse_args(MESH_EDGE_ARGV)
    idx = MonarchKVIndex(httpd.kv_config(args, True),
                         slab_store=KVSlabStore(), device="cuda")
    queue = AdmitQueue(idx, background=False)
    gaps = RecordedGaps(np)
    eng = PrefixResumeEngine(params, cfg,
                             max_seq=args.prompt_len + args.decode_tokens,
                             index=idx, decode_tokens=args.decode_tokens,
                             device="cuda", on_logits=gaps.record)
    per_request = []

    def prefill_rows(toks, hits):
        run = eng._resume_run(idx.fingerprints(toks), hits, toks.shape[1])
        parts = []
        for r in range(toks.shape[0]):
            h = np.zeros_like(hits[r:r + 1])
            h[:, :run] = True
            parts.append(eng.prefill(toks[r:r + 1], h))
        slabs = {}
        for part in parts:                  # the batch's: first row wins
            for fp, slab in part.slabs.items():
                slabs.setdefault(fp, slab)
        return PrefillResult(
            state=[part.state for part in parts], slabs=slabs,
            resumed_chunks=sum(part.resumed_chunks for part in parts),
            computed_chunks=sum(part.computed_chunks for part in parts))

    def decode_rows(toks, res):
        out, row_gaps = [], []
        for state in res.state:
            out.append(eng.decode(state))
            row_gaps.append(gaps.take())
        per_request.append(np.concatenate(row_gaps, axis=0))
        return np.concatenate(out, axis=0)

    def decode_whole(toks, res):
        out = eng.decode(res)
        per_request.append(gaps.take())
        return out

    t0 = time.perf_counter()
    if rows_alone:
        recs = serve.run_request_loop(queue, batches, prefill_fn=prefill_rows,
                                      decode_fn=decode_rows)
    else:
        recs = serve.run_request_loop(queue, batches, prefill_fn=eng.prefill,
                                      decode_fn=decode_whole)
    seconds = time.perf_counter() - t0
    queue.close()
    return recs, per_request, seconds


def first_divergences(np, got, want, gaps) -> list:
    """(request, row, step, the reference's top-2 gap) of each row's
    first token that differs."""
    out = []
    for i, (g, w, gap) in enumerate(zip(got, want, gaps)):
        for r in range(w.shape[0]):
            t = np.flatnonzero(np.asarray(g[r]) != np.asarray(w[r]))
            if t.size:
                out.append((i, r, int(t[0]), round(float(gap[r, t[0]]), 4)))
    return out


def mesh_edge_check(np, torch, workdir: str) -> dict:
    """(b) ``launch/httpd.py --mesh host`` under torchrun, qwen3-moe at
    full width and MESH_MOE_LAYERS layers with ``--n-shards 4``: rank 0
    answers EDGE_REQUESTS POSTs of MESH_EDGE_ROWS rows, one row a rank.
    Chunks, hits, resumed chunks and admissions equal the one-process
    loop that serves each row alone (:func:`edge_loop`), and the tokens
    equal its under the margin rule (its gaps); then a SIGTERM to
    torchrun drains both ranks.  Also measured, not held: the same loop
    run again (its run-to-run spread) and the loop at B = 2."""
    import signal

    from repro_torch.models import transformer

    cfg = edge_moe_config()
    batches = edge_requests(np, cfg.vocab_size, MESH_EDGE_ROWS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    alone, alone_gaps, alone_s = edge_loop(np, cfg, params, batches, True)
    again, _, _ = edge_loop(np, cfg, params, batches, True)
    whole, whole_gaps, whole_s = edge_loop(np, cfg, params, batches, False)
    del params
    free_card(torch)
    spread = first_divergences(np, [r.decoded for r in again],
                               [r.decoded for r in alone], alone_gaps)
    shape = first_divergences(np, [r.decoded for r in whole],
                              [r.decoded for r in alone], alone_gaps)
    log_path = pathlib.Path(workdir) / "httpd.log"
    proc = start_torchrun(["httpd", workdir], log_path)
    try:
        port, deadline = None, time.monotonic() + MESH_TIMEOUT_S
        while port is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            m = re.search(
                r"listening on http://127.0.0.1:(\d+)",
                log_path.read_text())
            if m:
                port = int(m[1])
            else:
                time.sleep(0.5)
        if port is None:
            raise AssertionError("phase 3g (b): the edge did not listen:\n"
                                 + log_path.read_text()[-6000:])
        t0 = time.perf_counter()
        mesh = []
        for t in batches:
            status, doc = http_json("POST", "127.0.0.1", port,
                                    "/v1/generate", {"tokens": t.tolist()})
            if status != 200:
                raise AssertionError(f"POST answered {status}: {doc}")
            mesh.append(doc)
        mesh_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
    finally:
        text = wait_torchrun(proc, log_path)
    if "[httpd] drained in" not in text or \
            f"[httpd] rank 1 drained: {EDGE_REQUESTS} batches" not in text:
        raise AssertionError(f"phase 3g (b): no drain of both ranks:\n"
                             f"{text[-6000:]}")
    ranks = [result_of("httpd", workdir, r) for r in range(MESH_WORLD)]
    for g, w, gap in zip(mesh, alone, alone_gaps):
        got = [g[k] for k in ("chunks", "hit_chunks", "resumed_chunks",
                              "admitted")]
        if got != [w.chunks, w.hit_chunks, w.resumed_chunks, w.admitted]:
            raise AssertionError(f"mesh answer {g} against {w}")
        if not greedy_margin_agree(np.array(g["tokens"]), w.decoded, gap):
            raise AssertionError(f"mesh tokens {g['tokens']} against "
                                 f"{w.decoded.tolist()} (gaps "
                                 f"{gap.tolist()})")
    if any(r["launches"] <= 0 for r in ranks):
        raise AssertionError(f"a rank launched no multi-set search: {ranks}")
    diverged = first_divergences(np, [np.array(g["tokens"]) for g in mesh],
                                 [r.decoded for r in alone], alone_gaps)
    equal = float(np.mean([np.array_equal(g["tokens"], w.decoded)
                           for g, w in zip(mesh, alone)]))
    log(f"phase 3g (b) qwen3-moe x{MESH_MOE_LAYERS} behind the edge on "
        f"(2, 1), {MESH_EDGE_ROWS} rows a request: {EDGE_REQUESTS} requests "
        f"answered by rank 0 in {mesh_s:.2f} s (one process, rows alone "
        f"{alone_s:.2f} s, B = 2 {whole_s:.2f} s), hits "
        f"{[g['hit_chunks'] for g in mesh]}, resumed "
        f"{[g['resumed_chunks'] for g in mesh]}; requests' tokens equal to "
        f"rows alone {equal:.3f}, first divergences (request, row, step, "
        f"gap) {diverged}; rows alone run again: {spread}; at B = 2: "
        f"{shape}; both ranks drained; multi-set launches a rank "
        f"{[r['launches'] for r in ranks]}, peak "
        f"{[round(r['peak_bytes'] / 1e9, 2) for r in ranks]} GB")
    return {"ranks": ranks, "mesh_s": mesh_s, "one_process_s": alone_s,
            "one_process_b2_s": whole_s, "tokens_equal": equal,
            "divergences": diverged, "run_to_run_divergences": spread,
            "b2_divergences": shape}


def mp_ssm_config():
    """zamba2-2.7b at full width and MP_SSM_LAYERS layers, phase 3g
    (d)'s config."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MP_SSM_ARCH),
                               n_layers=MP_SSM_LAYERS)


def ssm_step_gather_bytes(cfg, rows: int) -> int:
    """The all-gather output bytes of one decode step of an SSM stack
    whose every SSM weight has its last dimension split over ``model``
    (``ssm._decode_on_rows``): each Mamba-2 layer gathers ``z`` and
    ``dt``'s heads (float32 inside a layer group, bf16 in a remainder
    block), ``xBC`` before and after the conv (d_inner + 2N, bf16 each)
    and its output (d_model, bf16); each Mamba-1 layer ``xh`` before and
    after the conv (bf16), ``z`` and ``dt`` (float32 in a group), the
    ``x_proj`` product (dt rank + 2N) and its output."""
    group, n_groups, rem = cfg.scan_groups()
    di, n, d = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.d_model
    per = 0
    for kind, fused in ([(k, True) for k in group] * n_groups
                        + [(k, False) for k in rem]):
        f = 4 if fused else 2
        if kind == "mamba2":
            per += f * (di + di // cfg.ssm_head_dim) + 4 * (di + 2 * n) \
                + 2 * d
        elif kind == "mamba1":
            per += 4 * di + 2 * f * di + 2 * (max(d // 16, 1) + 2 * n) \
                + 2 * d
    return rows * per


def mp_ssm_one_process(np, torch) -> dict:
    """(d)'s reference: MP_SSM_ARGV at MP_SSM_LAYERS layers served in this
    process on the card, its records and every greedy step's top-2 gap;
    the card freed after."""
    from repro_torch.launch import serve
    gaps = RecordedGaps(np)
    run = serve.serve(serve.parse_args(MP_SSM_ARGV), cfg=mp_ssm_config(),
                      on_logits=gaps.record)
    one = {"records": [[r.chunks, r.hit_chunks, r.resumed_chunks,
                        int(r.admitted), r.decoded.tolist()]
                       for r in run.records],
           "gaps": [g.tolist() for g in gaps.per_request(SSM_DECODE)],
           "admissions": run.index.stats.admissions, "seconds": run.seconds}
    del run
    free_card(torch)
    return one


def mesh_serve_phase(np, torch, smi: str, base_bytes: int,
                     one: dict) -> dict:
    """Phase 3g: free the card of phase 3f, then (a) the serve launcher
    and (b) the edge over a (2, 1) mesh of two ranks of ``cuda:0``, (c)
    the serve launcher and (d) zamba2-2.7b over (1, 2), each under
    torchrun."""
    import shutil
    import tempfile

    left = free_card(torch)
    log(f"phase 3g: {left / 1e9:.4f} GB allocated after phase 3f "
        f"(before phase 3: {base_bytes / 1e9:.4f} GB)")
    if left > base_bytes + (64 << 20):
        raise AssertionError(f"phase 3f left {left - base_bytes} bytes on "
                             "the card")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_")
    try:
        ssm_one = mp_ssm_one_process(np, torch)
        serve_ranks(tmp)
        served = mesh_serve_check(np, torch, one, tmp)
        model_parallel = mesh_serve_check(np, torch, one, tmp, "serve_mp")
        ssm_parallel = mesh_serve_check(np, torch, ssm_one, tmp,
                                        "serve_ssm")
        edge = mesh_edge_check(np, torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 3g: {wall:.1f} s")
    report = {"serve": served, "edge": edge,
              "model_parallel": model_parallel,
              "ssm_model_parallel": ssm_parallel, "wall_s": wall,
              "card": smi}
    print(json.dumps({"mesh_serving": report}), flush=True)
    return report


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
    t_bytes = n_bytes / h100().hbm_bw * 1e3
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
                sector_bound_ms=sector_bytes / h100().hbm_bw * 1e3))
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


SPLIT_DEVICES = ("cuda:0", "cuda:0")   # the ("grid",) mesh of one card


def split_family_check(torch, sim, cfgs, trace_list, fams, res, states):
    """The first Fig. 9 family whose lane count the two devices divide,
    through ``simulate_grid(devices=SPLIT_DEVICES)``: two contiguous
    blocks of lanes, one graph-replayed run each.  Every result and final
    state equals the unsharded sweep's exactly."""
    from repro_torch.launch import mesh
    from repro_torch.pytree import tree_leaves
    fam = next(f for f in fams if mesh.make_grid_mesh(
        f["lanes"], SPLIT_DEVICES) is not None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, got_st = sim.simulate_grid({n: cfgs[n] for n in fam["configs"]},
                                    trace_list, device="cuda",
                                    devices=SPLIT_DEVICES, return_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for key, r in got.items():
        if r != res[key]:
            raise AssertionError(f"split family {key}: {r} != {res[key]}")
        for a, b in zip(tree_leaves(got_st[key]), tree_leaves(states[key])):
            if not torch.equal(a, b):
                raise AssertionError(f"split family {key}: final state "
                                     "differs from the unsharded run's")
    return {"configs": fam["configs"], "lanes": fam["lanes"],
            "devices": list(SPLIT_DEVICES), "keys": len(got),
            "wall_s": wall, "unsharded_wall_s": fam["wall_s"]}


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
    res9, st9, fam9 = run_families(torch, sim, cfgs, trace_list,
                                   return_state=True)
    sweep9_s = time.perf_counter() - t0
    fig9 = fig9_numbers(res9, specs, FIG9_SYSTEMS)
    split = split_family_check(torch, sim, cfgs, trace_list, fam9, res9, st9)

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
    log(f"phase 7: {compared} Fig. 9/11 baseline values reproduced exactly; "
        f"family {split['configs']} split over {split['devices']} in "
        f"{split['wall_s']:.1f} s equals the unsharded run")
    log(f"phase 7: Fig. 9 sweep {sweep9_s:.1f} s, Fig. 11 sweep "
        f"{sweep11_s:.1f} s, peak device memory of one family's "
        f"simulate_grid {peak / 2 ** 20:.1f} MiB")
    return {"requests": n_requests, "scale_blocks": SIM_SCALE,
            "baseline_values_equal": compared,
            "trace_gen_s": gen9_s + gen11_s,
            "fig9_sweep_s": sweep9_s, "fig11_sweep_s": sweep11_s,
            "peak_mem_bytes": peak, "families": fam9 + fam11,
            "split_family": split,
            "fig9": fig9, "fig11": fig11}


# ---------------------------------------------------------------------------
# Phase 8: the tooling — machine profile, multi-set autotuning, the bench
# harness and its envelope, the FLOP count of a train step.
# ---------------------------------------------------------------------------

PLANTED_EVERY = 3                  # every 3rd sweep query gets a stored hit
HARNESS_N = 8192                   # bf16 matmul timed through time_callable


def planted(np, torch, operands, slot, block_q: int, packed: bool):
    """The sweep's operands with every PLANTED_EVERY-th query's key stored
    in a valid way of its set (way chosen per query from a fixed seed, in
    query order), so the answers carry hits.  The planes come out the
    same whatever ``block_q`` packed the batch."""
    from repro_torch.kernels.common import pack_bits_np

    keys, masks, planes, valid, block_sets, live = (
        t.cpu().numpy().copy() for t in operands)
    c = valid.shape[1]
    ways = np.random.default_rng(1).integers(0, c, len(slot))
    for i in range(0, len(slot), PLANTED_EVERY):
        row = slot[i]
        s = block_sets[row // block_q]
        col = keys[row][:, None]
        planes[s, :, ways[i]] = (pack_bits_np(col, axis=0)[:, 0] if packed
                                 else col[:, 0])
        valid[s, ways[i]] = 1
    return tuple(torch.from_numpy(a).cuda() for a in (
        keys, masks, planes, valid, block_sets, live))


def sweep_check(np, torch, timer, cache_path) -> dict:
    """``autotune(out_path=cache_path, device="cuda")``; then, for every
    plane format, bucket, shape of the bucket and candidate, the answers
    on the sweep's inputs and on the same inputs with planted hits must
    equal the cold width's and the plain version's bit for bit; each
    candidate's cold-L2 device time (``graph_ms``) beside the sweep's own
    warm-L2 device times, and the width each family chose beside the
    committed file's."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.xam_search import ops as xam
    from repro_torch.kernels.xam_search.ref import xam_search_multiset_plain

    committed = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())
    before = xam.LAUNCH_COUNT
    t0 = time.perf_counter()
    payload = autotune.autotune(cache_path, device="cuda")
    sweep_s = time.perf_counter() - t0
    launches = xam.LAUNCH_COUNT - before
    rows, chosen, hits = [], {}, 0
    for fmt in ("int8", "packed8"):
        for bucket, shapes in autotune.BUCKET_SHAPES.items():
            key = f"xam_multiset/{payload['backend']}/{fmt}/{bucket}"
            fam = payload["families"][key]
            cold_bq = fam["cold_block_q"]
            chosen[f"{fmt}/{bucket}"] = {
                "block_q": fam["block_q"], "cold_block_q": cold_bq,
                "committed_block_q": committed["families"].get(
                    key, {}).get("block_q")}
            for si, (n_sets, n_q) in enumerate(shapes):
                answers = {}
                for bq in sorted(autotune.BLOCK_Q_CANDIDATES,
                                 key=lambda b: b != cold_bq):  # cold first
                    ops_, slot = autotune.multiset_workload(
                        n_sets, n_q, bq, fmt, "cuda")
                    for kind, args in (("sweep", ops_), ("planted", planted(
                            np, torch, ops_, slot, bq, fmt == "packed8"))):
                        got = xam.xam_search_multiset_device(*args,
                                                             block_q=bq)
                        plain = xam_search_multiset_plain(*args, block_q=bq)
                        assert_equal(torch, got, plain,
                                     f"sweep {fmt} Q={n_q} block_q {bq} "
                                     f"{kind}")
                        ans = got.cpu().numpy()[slot]
                        answers.setdefault(kind, ans)
                        if not np.array_equal(ans, answers[kind]):
                            raise AssertionError(
                                f"sweep {fmt} Q={n_q} {kind}: block_q {bq} "
                                f"answers differ from the cold width "
                                f"{cold_bq}")
                        if kind == "planted" and bq == cold_bq:
                            hits += int((ans >= 0).sum())
                    cold_l2_us = timer.graph_ms(
                        lambda: xam.xam_search_multiset_device(
                            *ops_, block_q=bq)) * 1e3
                    t = fam["swept"][str(bq)]
                    rows.append([fmt, n_sets, n_q, bq, t["q1_us"][si],
                                 t["median_us"][si], t["q3_us"][si],
                                 round(cold_l2_us, 3)])
                    log(f"sweep {fmt}/{bucket} ({n_sets} sets, Q={n_q}) "
                        f"block_q {bq:3d}: device {t['median_us'][si]:7.3f} "
                        f"us ({t['q1_us'][si]:.3f}-{t['q3_us'][si]:.3f}), "
                        f"cold L2 {cold_l2_us:7.3f} us"
                        f"{'  <- chosen' if bq == fam['block_q'] else ''}"
                        f"{'  (cold)' if bq == cold_bq else ''}")
    if hits == 0:
        raise AssertionError("the planted sweep batches found no hit")
    log(f"phase 8: sweep wrote {cache_path.name} in {sweep_s:.2f} s "
        f"({launches} launches); chosen {chosen}; every candidate's answers "
        f"equal the cold width's and the plain version's ({hits} planted "
        f"hits)")
    return {"sweep_s": sweep_s, "launches_autotune": launches,
            "backend": payload["backend"], "chosen": chosen,
            "candidates": {"columns": [
                "plane_format", "sets", "queries", "block_q",
                "q1_us", "median_us", "q3_us", "cold_l2_us"],
                "rows": rows}, "planted_hits": hits}


#: Fingerprints per warm-cache lookup batch: the serve launcher's batch
#: and ``KVIndexConfig``'s default, one in each bucket.
WARM_FPS = {"narrow": 96, "wide": 256}


def warm_lookup_check(np, torch, cache_path) -> dict:
    """One lookup batch per plane format and bucket through a
    ``MonarchKVIndex`` (the serving geometry, ``KVIndexConfig``'s
    defaults) on the card, under the cold cache and under the swept one:
    every way index and every counter equal; the widths each used."""
    import os
    from repro_torch.kernels import autotune
    from repro_torch.kernels.xam_search import ops as xam
    from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                            MonarchKVIndex)

    real_search = xam.xam_search_multiset
    real_device = xam.xam_search_multiset_device
    seen: dict = {}

    def search(*a, **k):
        ways = real_search(*a, **k)
        seen["ways"] = ways.copy()
        return ways

    def device(*a, **k):
        seen["block_q"] = k["block_q"]
        return real_device(*a, **k)

    def run(fmt: str, n_fps: int, cache: str) -> dict:
        os.environ[autotune.CACHE_ENV] = cache
        autotune.reset_cache()
        idx = MonarchKVIndex(KVIndexConfig(plane_format=fmt,
                                           admit_after_reads=0),
                             device="cuda")
        rng = np.random.default_rng(7)
        toks = rng.integers(1, 60_000, (8, n_fps // 8 * CHUNK_TOKENS)
                            ).astype(np.int32)
        idx.admit_fps(np.unique(idx.fingerprints(toks[::2]).reshape(-1)))
        hit = idx.lookup(toks)
        return {"ways": seen["ways"], "hit": hit, "block_q": seen["block_q"],
                "stats": dataclasses.asdict(idx.stats)}

    old = os.environ.get(autotune.CACHE_ENV)
    xam.xam_search_multiset = search
    xam.xam_search_multiset_device = device
    out = []
    try:
        for fmt in ("int8", "packed8"):
            for bucket, n_q in WARM_FPS.items():
                cold = run(fmt, n_q, str(cache_path.with_name("absent")))
                warm = run(fmt, n_q, str(cache_path))
                if not (np.array_equal(cold["ways"], warm["ways"])
                        and np.array_equal(cold["hit"], warm["hit"])
                        and cold["stats"] == warm["stats"]):
                    raise AssertionError(
                        f"warm lookup {fmt}/{bucket}: cold {cold['stats']} "
                        f"vs warm {warm['stats']}")
                if not cold["hit"].any() or cold["hit"].all():
                    raise AssertionError(f"lookup {fmt}/{bucket}: hits "
                                         f"{int(cold['hit'].sum())}")
                out.append({"plane_format": fmt, "bucket": bucket,
                            "n_fps": int(cold["hit"].size),
                            "cold_block_q": cold["block_q"],
                            "warm_block_q": warm["block_q"],
                            "hits": int(cold["hit"].sum()),
                            "stats": cold["stats"]})
                log(f"warm lookup {fmt}/{bucket}: {cold['hit'].size} fps, "
                    f"{int(cold['hit'].sum())} hits, block_q cold "
                    f"{cold['block_q']} / warm {warm['block_q']}: ways and "
                    f"counters equal")
    finally:
        xam.xam_search_multiset = real_search
        xam.xam_search_multiset_device = real_device
        if old is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = old
        autotune.reset_cache()
    return out


def harness_check(torch, timer, cache_path, tmp: str) -> dict:
    """``time_callable`` of a bf16 matmul against its CUDA-event time
    (its median must be at least 0.9 of it: ``_block`` synchronised);
    then ``emit_json`` into ``tmp`` read back."""
    import os
    from repro_torch.bench import emit_json, time_callable
    from repro_torch.kernels import autotune

    x = torch.randn(HARNESS_N, HARNESS_N, device="cuda",
                    dtype=torch.bfloat16)
    t = time_callable(lambda: x @ x, warmup=2, reps=10)
    event_ms = statistics.median(timer._events_ms(lambda: x @ x)
                                 for _ in range(10))
    del x
    if not t.median_us / 1e3 >= 0.9 * event_ms:
        raise AssertionError(f"time_callable median {t.median_us} us under "
                             f"the event time {event_ms} ms: no sync")
    saved = {k: os.environ.get(k) for k in ("BENCH_OUT_DIR",
                                             autotune.CACHE_ENV)}
    os.environ["BENCH_OUT_DIR"] = tmp
    os.environ[autotune.CACHE_ENV] = str(cache_path)
    try:
        path = emit_json("torch_autotune", {"probe": True}, quick=False)
        doc = json.loads(pathlib.Path(path).read_text())
        want_fp = autotune.cache_fingerprint()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reset_cache()
    if not (doc["device"] == "cuda" and doc["machine"] == "h100-sxm"
            and doc["autotune_cache"] == want_fp and doc["device_name"]
            and doc["power_limit_w"] > 0 and doc["quick"] is False):
        raise AssertionError(f"emit_json envelope: {doc}")
    envelope = {k: v for k, v in doc.items() if k != "probe"}
    log(f"harness: time_callable median {t.median_us:.1f} us (best "
        f"{t.best_us:.1f}) of a {HARNESS_N}^2 bf16 matmul whose event time "
        f"is {event_ms * 1e3:.1f} us; envelope {envelope}")
    return {"median_us": t.median_us, "best_us": t.best_us,
            "event_ms": event_ms, "envelope": envelope}


def tooling_phase(np, torch, timer, smi: str, training: dict) -> dict:
    """Phase 8: the machine profile, the sweep, a warm-cache lookup, the
    harness and its envelope, and phase 3e's counted step."""
    import shutil
    import tempfile
    from repro_torch.roofline.analysis import current_machine

    machine = current_machine()
    log(f"phase 8: card {smi}; machine profile {machine}")
    if machine.name != "h100-sxm":
        raise AssertionError(f"machine profile {machine.name} on {smi}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    try:
        cache = pathlib.Path(tmp) / "autotune_cache.json"
        sweep = sweep_check(np, torch, timer, cache)
        warm = warm_lookup_check(np, torch, cache)
        harness = harness_check(torch, timer, cache, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    z = training["zamba2_train"]
    flops = {k: z[k] for k in ("step_flops", "model_flops",
                               "step_over_model_flops", "counted_step_s",
                               "median_step_s")}
    log(f"phase 8: zamba2-2.7b train step at 2 x 512 counted "
        f"{z['step_flops']:.6e} FLOPs, model_flops {z['model_flops']:.6e}, "
        f"ratio {z['step_over_model_flops']:.4f}; phase 3e's median step "
        f"{z['median_step_s']:.3f} s")
    return {"machine": machine.name, "card": smi, "sweep": sweep,
            "warm_lookup": warm, "harness": harness, "flops": flops}


# ---------------------------------------------------------------------------
# Phase 9: the launch layer's dry run on the card's host mesh, and the four
# examples on the card against the CPU.
# ---------------------------------------------------------------------------

ZAMBA_TRAIN_SHAPE = ("train_512", 512, 2, "train")     # phase 3e's steps
DRYRUN_WORKERS = 8                 # dry-run processes at once, a host core each
DRYRUN_TIMEOUT_S = 600
DRYRUN_CHILD = "--dryrun-child"    # argv[1] of a dry-run process it spawns
# argv of each example, and the kernels its run on the card must launch
EXAMPLES = {
    "quickstart_torch": ([], ("xam_search",)),
    "kv_store_torch": ([], ("xam_search", "hopscotch_lookup")),
    "string_search_torch": (["--mib", "1"], ("string_match",)),
    "serve_prefix_cache_torch": (["--requests", "5", "--decode-tokens", "2"],
                                 ("xam_search_multiset",)),
}
# host times and the route an example names vary between runs and devices
_VARYING = r"\d+(\.\d+)? ?m?s\b( \((CUDA kernel on the card|plain version " \
           r"on the CPU)\))?"


def dryrun_records(jobs: list, out_dir: str) -> dict:
    """``launch.dryrun.run_cell`` of each (arch, shape, mesh) of ``jobs``
    in DRYRUN_WORKERS processes of this script (``DRYRUN_CHILD``), the
    jobs dealt out in turn, the long train and prefill cells first (each
    trace is one host core's work): {job: its record}; a process that
    fails raises, once every other has ended."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = sorted(jobs, key=lambda job: job[1] not in ("train_4k",
                                                       "prefill_32k"))
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def one(share):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), DRYRUN_CHILD,
             out_dir, *(":".join(job) for job in share)],
            env=env, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"dry run of {share}: rc {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")

    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        list(pool.map(one, [jobs[k::DRYRUN_WORKERS]
                            for k in range(DRYRUN_WORKERS)]))
    out = {}
    for arch, shape, mesh in jobs:
        with open(os.path.join(out_dir, f"{mesh}__{arch}__{shape}.json")) as f:
            out[arch, shape, mesh] = json.load(f)
    return out


def dryrun_child(argv: list) -> int:
    """A process of :func:`dryrun_records`: ``out_dir`` and then
    ``arch:shape:mesh`` jobs, each ``launch.dryrun.run_cell`` in turn."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    out_dir, jobs = argv[0], argv[1:]
    for job in jobs:
        dryrun.run_cell(*job.split(":"), out_dir)
    return 0


def dryrun_cells(torch, records: dict) -> list:
    """(a) ``launch.dryrun.run_cell`` of every cell on the host mesh (the
    runnable ones' ``records``): one line each; a runnable cell that
    fails to trace has raised."""
    from repro_torch import configs
    from repro_torch.launch import dryrun

    card = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for cfg, shape, ok, why in configs.all_cells():
        rec = (records[cfg.name, shape.name, "host"] if ok else
               dryrun.run_cell(cfg.name, shape.name, "host"))
        if not ok:
            log(f"dryrun {cfg.name} x {shape.name}: skipped ({why})")
            rows.append(rec)
            continue
        mem, roof = rec["memory"], rec["roofline"]
        if rec["n_devices"] != 1 or mem["card_bytes"] != card or \
                rec["machine"] != "h100-sxm" or not rec["flops"] > 0:
            raise AssertionError(f"dryrun record {rec}")
        if mem["peak_exceeds_card"] != (mem["peak_bytes"] > card) or \
                mem["temp_bytes"] is None:
            raise AssertionError(f"dryrun memory record {mem}")
        log(f"dryrun {cfg.name} x {shape.name}: inputs "
            f"{mem['analytic_input_bytes_per_device'] / 1e9:.2f} GB/device, "
            f"peak {mem['peak_bytes'] / 1e9:.2f} GB/device "
            f"({mem['memory_method']}) of the card's {card / 1e9:.2f} GB "
            f"(inputs exceed: {mem['inputs_exceed_card']}, peak exceeds: "
            f"{mem['peak_exceeds_card']}), counted "
            f"{rec['flops'] / 1e12:.4f} TFLOPs, model_flops "
            f"{roof['model_flops'] / 1e12:.4f} T, compute "
            f"{roof['compute_s']:.4g} s, memory {roof['memory_s']:.4g} s, "
            f"collective {roof['collective_s']:.4g} s -> "
            f"{roof['bottleneck']}; {rec['flops_method']}, trace "
            f"{rec['trace_s']:.2f} s")
        rows.append({k: rec[k] for k in ("arch", "shape", "runnable",
                                         "flops", "flops_method",
                                         "trace_s", "hbm_bytes")}
                    | {"input_bytes": mem["analytic_input_bytes_per_device"],
                       "inputs_exceed_card": mem["inputs_exceed_card"],
                       **{k: mem[k] for k in (
                           "argument_bytes", "output_bytes", "alias_bytes",
                           "temp_bytes", "peak_bytes", "memory_method",
                           "peak_exceeds_card")},
                       "model_flops": roof["model_flops"],
                       "compute_s": roof["compute_s"],
                       "memory_s": roof["memory_s"],
                       "bottleneck": roof["bottleneck"]})
    return rows


#: Phase 9 (b)'s bounds: a step's dry-run peak less its arguments within
#: MEMORY_RTOL of the card's step peak or MEMORY_ATOL, whichever is larger,
#: and its argument bytes within ARGUMENT_RTOL of the card's
MEMORY_RTOL, MEMORY_ATOL, ARGUMENT_RTOL = 0.10, 128 << 20, 1e-3


def memory_vs_card(name: str, count: dict, card: dict) -> dict:
    """One step's dry-run memory (``launch.dryrun.count_step``'s
    ``count``) against the card's (:func:`step_memory`): a line with both
    and their ratios; raises where a bound of phase 9 (b) is missed."""
    dry, method = count["memory"], count["memory_method"]
    step = dry["peak_bytes"] - dry["argument_bytes"]
    want = card["step_peak_bytes"]
    on_card = card["counted_on_card"]
    row = {"dry_argument_bytes": dry["argument_bytes"],
           "dry_temp_bytes": dry["temp_bytes"],
           "dry_peak_bytes": dry["peak_bytes"],
           "dry_step_peak_bytes": step,
           "memory_method": method,
           "card_argument_bytes": card["argument_bytes"],
           "card_step_peak_bytes": want,
           "card_peak_bytes": card["argument_bytes"] + want,
           "card_entry_bytes": card["entry_bytes"],
           "counted_on_card": on_card,
           "step_peak_ratio": step / want,
           "argument_ratio": dry["argument_bytes"] / card["argument_bytes"],
           "card_minus_counted_on_card_bytes": want - (
               on_card["peak_bytes"] - on_card["argument_bytes"]),
           "counted_on_card_minus_dry_bytes": (
               on_card["peak_bytes"] - on_card["argument_bytes"]) - step}
    log(f"dryrun vs card, {name}: dry run arguments "
        f"{dry['argument_bytes']} B, temp {dry['temp_bytes']} B, peak "
        f"{dry['peak_bytes']} B ({method}); card arguments "
        f"{card['argument_bytes']} B, peak {row['card_peak_bytes']} B "
        f"(step {want} B over {card['entry_bytes']} B at entry); ratios: "
        f"step peak {row['step_peak_ratio']:.4f}, arguments "
        f"{row['argument_ratio']:.6f}; allocator over the count on the "
        f"card {row['card_minus_counted_on_card_bytes']} B, the count on "
        f"the card over meta {row['counted_on_card_minus_dry_bytes']} B")
    if abs(step - want) > max(MEMORY_RTOL * want, MEMORY_ATOL):
        raise AssertionError(
            f"{name}: dry-run step peak {step} B against the card's {want} B "
            f"(bound {MEMORY_RTOL:.0%} or {MEMORY_ATOL} B)")
    if abs(dry["argument_bytes"] - card["argument_bytes"]) > \
            ARGUMENT_RTOL * card["argument_bytes"]:
        raise AssertionError(
            f"{name}: dry-run arguments {dry['argument_bytes']} B against "
            f"the card's {card['argument_bytes']} B")
    return row


def dryrun_vs_card(torch, zamba: dict, serving: dict, moe: dict) -> dict:
    """(b) Steps that ran on the card, dry-run at the same shapes on the
    host mesh: zamba2-2.7b's train step at phase 3e's 2 x 512, whose
    FLOPs equal phase 8's counted step exactly, and (i) its memory, (ii)
    yi-9b's prefill and (iii) decode at phase 3's 2 x 96 and
    qwen3-moe-30b-a3b's MoE prefill at phase 3c's against the card's
    (:func:`memory_vs_card`)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg, shape = get_arch("zamba2-2.7b"), ShapeConfig(*ZAMBA_TRAIN_SHAPE)
    mesh = make_host_mesh()
    count = dryrun.count_step(cfg, shape, mesh)
    _, args, in_specs, _ = dryrun.build_cell(cfg, shape, mesh)
    inputs = dryrun.analytic_input_bytes_per_device(args, in_specs, mesh)
    peak = zamba["peak_mem_bytes"]
    log(f"dryrun zamba2-2.7b train 2 x 512: {count['flops']:.6e} FLOPs "
        f"({count['flops_method']}) against phase 8's counted step "
        f"{zamba['step_flops']:.6e} on the card; inputs {inputs / 1e9:.2f} "
        f"GB against phase 3e's peak {peak / 1e9:.2f} GB (ratio "
        f"{inputs / peak:.4f})")
    if count["flops"] != zamba["step_flops"]:
        raise AssertionError(f"dry-run FLOPs {count['flops']} != the card's "
                             f"counted {zamba['step_flops']}")
    if inputs > peak:
        raise AssertionError(f"dry-run inputs {inputs} B exceed the measured "
                             f"peak {peak} B")
    memory = {"zamba2-2.7b train": memory_vs_card(
        "zamba2-2.7b train 2 x 512", count, zamba["step_memory"])}
    for arch, kind, card in (("yi-9b", "prefill", serving["prefill"]),
                             ("yi-9b", "decode", serving["decode"]),
                             ("qwen3-moe-30b-a3b", "prefill",
                              moe["prefill"])):
        dry = dryrun.count_step(get_arch(arch),
                                ShapeConfig(*SERVE_MEMORY_SHAPES[kind]), mesh)
        memory[f"{arch} {kind}"] = memory_vs_card(f"{arch} {kind} 2 x 96",
                                                 dry, card)
    return {"flops": count["flops"], "card_step_flops": zamba["step_flops"],
            "flops_method": count["flops_method"],
            "input_bytes": inputs, "peak_mem_bytes": peak,
            "inputs_over_peak": inputs / peak, "trace_s": count["trace_s"],
            "memory": memory}


def stable_lines(text: str) -> list:
    """An example's output with host times and the named route masked."""
    import re
    return [re.sub(_VARYING, "<varies>", line) for line in text.splitlines()]


def run_example(name: str, argv: list) -> str:
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        load_example(name).main(argv)
    return out.getvalue()


def examples_check(torch) -> dict:
    """(c) Each example with ``--device cpu`` and then ``--device cuda``:
    the same lines but for times and the route, and on the card the
    launches of its kernels."""
    out = {}
    for name, (argv, kernels) in EXAMPLES.items():
        cpu = run_example(name, argv + ["--device", "cpu"])
        zero_counts()
        t0 = time.perf_counter()
        card = run_example(name, argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if stable_lines(card) != stable_lines(cpu):
            raise AssertionError(f"{name} on the card:\n{card}\non the CPU:"
                                 f"\n{cpu}")
        if not all(counts[k] > 0 for k in kernels):
            raise AssertionError(f"{name} launched {counts}, expected "
                                 f"{kernels}")
        log(f"example {' '.join([name] + argv)}: card lines equal the CPU's "
            f"({len(card.splitlines())} lines) in {wall:.2f} s; launches "
            f"{ {k: counts[k] for k in kernels} }")
        for line in card.splitlines():
            log(f"  {name}: {line}")
        out[name] = {"argv": argv, "wall_s": wall, "launches": counts,
                     "lines": card.splitlines()}
    return out


#: (d): (arch, shape, mesh) dry-run on the production meshes' fake worlds
PRODUCTION_DRYRUN = [(arch, shape, mesh) for mesh in ("single", "multi")
                     for arch, shape in (("yi-9b", "train_4k"),
                                         ("qwen3-moe-30b-a3b", "decode_32k"),
                                         ("zamba2-2.7b", "long_500k"))] + [
    ("yi-9b", "train_4k", "optsingle")]


def production_dryrun(torch, records: dict) -> list:
    """(d) ``launch.dryrun.run_cell`` of PRODUCTION_DRYRUN under the
    card's torch (their ``records``): each step placed over a fake world
    of 256 or 512 ranks (meta blocks) and counted as rank 0 runs it; one
    line each with its input bytes, peak, FLOPs and collective bytes by
    kind a device and the bottleneck on ``h100-sxm``."""
    from repro_torch.roofline.analysis import COLLECTIVES

    rows = []
    for arch, shape, mesh in PRODUCTION_DRYRUN:
        rec = records[arch, shape, mesh]
        n_dev = 512 if mesh.endswith("multi") else 256
        coll = rec["collectives"]
        if rec["n_devices"] != n_dev or rec["machine"] != "h100-sxm" or \
                not rec["flops"] > 0 or not coll["total"] > 0:
            raise AssertionError(f"dryrun record {rec}")
        inputs = rec["memory"]["analytic_input_bytes_per_device"]
        peak = rec["memory"]["peak_bytes"]
        log(f"dryrun {arch} x {shape} x {mesh}: inputs {inputs / 1e9:.3f} "
            f"GB/device, rank 0's peak {peak / 1e9:.3f} GB/device "
            f"({rec['memory']['memory_method']}, exceeds the card: "
            f"{rec['memory']['peak_exceeds_card']}), "
            f"{rec['flops'] / 1e12:.4f} TFLOPs/device "
            f"({rec['flops_method']}), collectives/device "
            + ", ".join(f"{k} {coll[k] / 1e9:.4f} GB" for k in COLLECTIVES)
            + f", total {coll['total'] / 1e9:.4f} GB -> "
            f"{rec['roofline']['bottleneck']} (compute "
            f"{rec['roofline']['compute_s']:.4g} s, memory "
            f"{rec['roofline']['memory_s']:.4g} s, collective "
            f"{rec['roofline']['collective_s']:.4g} s); trace "
            f"{rec['trace_s']:.1f} s")
        rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "n_devices": n_dev, "input_bytes": inputs,
                     "memory": rec["memory"],
                     "flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
                     "flops_method": rec["flops_method"],
                     "collectives": coll, "trace_s": rec["trace_s"],
                     "bottleneck": rec["roofline"]["bottleneck"]})
    return rows


def launch_phase(torch, smi: str, training: dict, serving: dict,
                 moe: dict) -> dict:
    """Phase 9: (a) the dry run of every cell, (b) the dry run against the
    steps measured on the card (the ``serving`` steps of phase 3, the
    ``moe`` prefill of 3c, phase 3e's ``training``), (c) the four
    examples, (d) the production meshes' dry run; (a)'s and (d)'s cells
    in processes of their own, side by side."""
    import shutil
    import tempfile

    from repro_torch import configs

    jobs = [(cfg.name, shape.name, "host")
            for cfg, shape, ok, _ in configs.all_cells() if ok]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        t0 = time.perf_counter()
        records = dryrun_records(jobs + PRODUCTION_DRYRUN, tmp)
        dryrun_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = dryrun_cells(torch, records)
    runnable = [c for c in cells if c["runnable"]]
    log(f"phase 9 (a), (d): {len(runnable)} runnable cells and "
        f"{len(PRODUCTION_DRYRUN)} production cells dry-run in {dryrun_s:.1f} "
        f"s, {DRYRUN_WORKERS} processes at a time; fit the card by their "
        f"inputs {sum(not c['inputs_exceed_card'] for c in runnable)}, by "
        f"their peak {sum(not c['peak_exceeds_card'] for c in runnable)}")
    vs_card = dryrun_vs_card(torch, training["zamba2_train"], serving, moe)
    t0 = time.perf_counter()
    examples = examples_check(torch)
    log(f"phase 9 (c): four examples in {time.perf_counter() - t0:.1f} s")
    production = production_dryrun(torch, records)
    return {"cells": cells, "dryrun_s": dryrun_s, "zamba2_train": vs_card,
            "examples": examples, "production": production, "card": smi}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device is visible: this script measures the card")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
        return 2
    if sys.argv[1:2] == [MESH_CHILD]:
        return mesh_child(sys.argv[2:])
    if sys.argv[1:2] == [TORCHRUN_CHILD]:
        return torchrun_child(sys.argv[2:])
    if sys.argv[1:2] == [DRYRUN_CHILD]:
        return dryrun_child(sys.argv[2:])
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
    ssm = ssm_phase(np, torch, smi, base_bytes)
    training = train_phase(np, torch, smi, base_bytes)
    meshed = mesh_phase(np, torch, smi, base_bytes)
    mesh_served = mesh_serve_phase(np, torch, smi, base_bytes,
                                   served["one_process"])

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
    t0 = time.perf_counter()
    tooling = tooling_phase(np, torch, timer, smi, training)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launch = launch_phase(torch, smi, training, served["step_memory"],
                          moe["edge"]["step_memory"])
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    example_launches = {name: sum(e["launches"][name]
                                  for e in launch["examples"].values())
                        for name in read_counts()}
    mesh_launches = {       # each rank's, counted in its own process
        part: [r["launches"] for r in mesh_served[part]["ranks"]]
        for part in ("serve", "edge", "model_parallel",
                     "ssm_model_parallel")}

    path_launches = {
        "xam_search_multiset": (serve_counts["xam_search_multiset"]
                                + gemma["edge"]["launches"]
                                + moe["shards"]["launches"]
                                + moe["edge"]["launches"]
                                + moe["edge"]["replay_launches"]
                                + sum(e["launches"] for e in ssm["edges"])
                                + sum(map(sum, mesh_launches.values()))
                                + example_launches["xam_search_multiset"]),
        "hopscotch_lookup": (table["point"]["launches"]["hopscotch_lookup"]
                             + example_launches["hopscotch_lookup"]),
        "string_match": (strings["launches"]["string_match"]
                         + example_launches["string_match"]),
        "xam_search": (api["launches"]["xam_search"]
                       + example_launches["xam_search"]),
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
        "launches_moe_replay_4_partitions": moe["edge"]["replay_launches"],
        "launches_ssm_edges": {e["arch"]: e["launches"]
                               for e in ssm["edges"]},
        "launches_mesh_serving_per_rank": mesh_launches,
        "launches_per_request_batch": served["launches"] / served["batches"],
        "launches_autotune": tooling["sweep"]["launches_autotune"],
        "launches_examples": example_launches["xam_search_multiset"],
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
            "launches_examples": example_launches[name],
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
    # The report first; the tooling and kernels lines last, where the end
    # of the output keeps them.
    print(json.dumps({"builds": builds,
                      "serve": served["times"],
                      "resume_check": served["resume_check"],
                      "resume_check_shallow": shallow,
                      "gemma3": gemma, "qwen3_moe": moe, "ssm": ssm,
                      "training": training, "mesh_training": meshed,
                      "mesh_serving": mesh_served,
                      "hashtable": table, "stringmatch": strings,
                      "monarch_api": api, "simulator": simulated,
                      "launch_layer": launch, "card": smi}), flush=True)
    print(json.dumps({"tooling": tooling, "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
