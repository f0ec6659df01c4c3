"""Synthetic memory traces standing in for the paper's CRONO + NAS
workloads (§9.2.1) — the port's own numpy copy of
``repro/data/traces.py``: the same arrays for the same (spec, seed) under
numpy 2.0, which made the committed baselines, and the same arrays under
any later numpy too (see ``_zipf``).

We cannot ship ESESC/qemu, so each application is modeled by its
memory-access SIGNATURE: footprint (paper: >= 2x the in-package capacity
for the graph apps), power-law reuse (graph frontier), sequential burst
length (CSR neighbor scans / FT strides), and write fraction (rank updates;
EP is write-heavy — the paper's minimum-lifetime app).  Parameters are
recorded per app so the calibration is inspectable.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    footprint_blocks: int      # relative to in-package capacity (x blocks)
    zipf_a: float              # reuse skew
    seq_burst: int             # avg sequential run length
    write_frac: float
    n_requests: int = 200_000
    # Strided conflict family (CSR row/col pointer walks): addresses that
    # alias into FEW cache sets, thrash low-associativity caches, and are
    # absorbed by Monarch's 512-way sets — the access structure behind the
    # paper's Fig-10 hit-rate gains (e.g. BC "more than 2x").
    stride_frac: float = 0.0   # fraction of requests from the family
    stride: int = 256          # block stride (aliases mod small set counts)
    stride_n: int = 192        # distinct lines in the family (<= 512)


# CRONO graph apps + NAS, calibrated signatures.  Graph apps carry a large
# strided conflict family (frontier/index walks); FT/CG a moderate one
# (transpose strides); EP nearly none (embarrassingly parallel RNG).
def crono_nas_specs(inpkg_blocks: int, n_requests: int = 200_000):
    fp = 2 * inpkg_blocks      # paper: inputs sized >= 2x in-package memory
    mk = lambda name, a, burst, wf, f=fp, sf=0.0, sn=192: TraceSpec(
        name, f, a, burst, wf, n_requests, stride_frac=sf, stride_n=sn)
    return [
        mk("BC", 1.10, 4, 0.20, sf=0.12, sn=320),
        mk("BFS", 1.05, 8, 0.10, sf=0.09),
        mk("COM", 1.20, 4, 0.25, sf=0.08),
        mk("CON", 1.10, 8, 0.15, sf=0.09),
        mk("DFS", 1.02, 2, 0.10, sf=0.06),
        mk("PR", 1.25, 16, 0.30, sf=0.11, sn=256),
        mk("SSSP", 1.10, 4, 0.20, sf=0.09),
        mk("TRI", 1.30, 8, 0.05, sf=0.08),
        mk("FT", 1.01, 64, 0.40, fp // 2, sf=0.05, sn=128),
        mk("CG", 1.15, 32, 0.15, fp // 2, sf=0.05, sn=128),
        mk("EP", 1.01, 16, 0.60, inpkg_blocks // 2),  # write-heavy, small fp
    ]


# Fraction of requests that re-reference the recent past (L2 capacity
# re-misses on lines still resident in L3): this is what arms the
# R-after-install flags the §8 D/R filter keys on.  One global constant for
# all apps, calibrated so the filter removes ~1/3 of eviction write traffic
# (paper: ~31%); per-app behavior still comes from the signature params.
REREFERENCE_FRAC = 0.65
REREFERENCE_GAP = 4    # per-THREAD gap (~64 interleaved requests)


N_THREADS = 16   # 8 OoO cores x 2 HW threads (§9.1): the interleaving of
# independent per-thread streams is what destroys DRAM row-buffer locality
# in the parallel apps (and what the refresh-free Monarch is immune to).


def generate(spec: TraceSpec, seed: int = 0):
    """Returns (addrs int64 block ids, is_write bool): N_THREADS per-thread
    streams, interleaved as they would arrive at the shared L3."""
    streams = [_gen_thread(spec, seed * N_THREADS + t)
               for t in range(N_THREADS)]
    rng = np.random.default_rng(seed + 12345)
    n = spec.n_requests
    order = rng.integers(0, N_THREADS, n)
    per = streams[0][0].shape[0]
    # occurrence index of each request within its thread (vectorized cumcount)
    sorted_i = np.argsort(order, kind="stable")
    counts = np.bincount(order, minlength=N_THREADS)
    occ = np.empty(n, np.int64)
    start = 0
    for t in range(N_THREADS):
        occ[sorted_i[start:start + counts[t]]] = np.arange(counts[t])
        start += counts[t]
    a_all = np.stack([s[0] for s in streams])
    w_all = np.stack([s[1] for s in streams])
    return a_all[order, occ % per], w_all[order, occ % per]


_INT64_MAX_F = float(np.iinfo(np.int64).max)


def _zipf(rng: np.random.Generator, a: float, n: int) -> np.ndarray:
    """``rng.zipf(a, n)`` as numpy 2.0 draws it, on any numpy version.

    numpy 2.1 changed ``Generator.zipf``'s rejection sampler, so the same
    seed gives other traces (and other benchmark numbers) from there on.
    This is numpy 2.0's sampler, drawn from the same bit-generator stream:
    each try takes two doubles ``u, v``, sets
    ``X = floor(pow(1 - u, -1 / (a - 1)))`` and accepts ``X`` when it fits
    an int64 and ``v * X * (T - 1) / (b - 1) <= T / b`` with
    ``T = pow(1 + 1/X, a - 1)``, ``b = pow(2, a - 1)``.  ``pow`` is the C
    library's (``math.pow``), as in numpy's C sampler: ``np.power`` may
    round differently.  Tries are drawn in bulk; the stream is then rewound
    to just past the n-th accepted try, so the generator ends where numpy
    2.0's would."""
    am1 = a - 1.0
    e = -1.0 / am1
    b = math.pow(2.0, am1)
    out = np.empty(n, np.int64)
    got = 0
    while got < n:
        start = rng.bit_generator.state
        tries = 2 * (n - got) + 64
        u = rng.random(2 * tries).reshape(tries, 2)
        base = 1.0 - u[:, 0]
        x = np.full(tries, np.inf)
        with np.errstate(over="ignore"):
            finite = np.power(base, e) < 1e300     # math.pow cannot overflow
        x[finite] = np.floor([math.pow(v, e) for v in base[finite]])
        fits = (x <= _INT64_MAX_F) & (x >= 1.0)
        t = np.ones(tries)
        t[fits] = [math.pow(1.0 + 1.0 / v, am1) for v in x[fits]]
        with np.errstate(invalid="ignore"):    # inf * 0 where X is inf
            accept = fits & (u[:, 1] * x * (t - 1.0) / (b - 1.0) <= t / b)
        hits = np.flatnonzero(accept)[:n - got]
        out[got:got + len(hits)] = x[hits].astype(np.int64)
        got += len(hits)
        if got == n:                      # rewind past the last accepted try
            rng.bit_generator.state = start
            rng.random(2 * (int(hits[-1]) + 1))
    return out


def _gen_thread(spec: TraceSpec, seed: int = 0):
    """One thread's stream (shared footprint + shared conflict family)."""
    # crc32, NOT hash(): str hashing is salted per process, which silently
    # made every trace (and so every benchmark number) run-dependent.
    rng = np.random.default_rng(seed + zlib.crc32(spec.name.encode()) % (2 ** 16))
    n = max(spec.n_requests // N_THREADS, 1024)
    # power-law base stream over the footprint
    base = _zipf(rng, spec.zipf_a, n) % spec.footprint_blocks
    # sequential bursts: run-length extend each base address
    burst = rng.geometric(1.0 / spec.seq_burst, n)
    addrs = np.repeat(base, burst)[: 2 * n]
    run_off = np.concatenate([np.arange(b) for b in burst])[: 2 * n]
    addrs = (addrs + run_off) % spec.footprint_blocks
    # strided conflict family: round-robin walk over stride_n aliasing lines
    if spec.stride_frac > 0:
        in_fam = rng.random(len(addrs)) < spec.stride_frac
        walk = np.cumsum(in_fam) % spec.stride_n
        fam_addr = (walk.astype(np.int64) * spec.stride) % spec.footprint_blocks
        addrs = np.where(in_fam, fam_addr, addrs)
    # temporal re-reference: replay positions re-read the address issued
    # REREFERENCE_GAP requests earlier in the FINAL stream (chains resolved
    # to the first non-replay ancestor, so a replay always targets an
    # address that was actually accessed).
    m = len(addrs)
    replay = rng.random(m) < REREFERENCE_FRAC
    gap = REREFERENCE_GAP
    src = np.arange(m)
    src = np.where(replay & (src >= gap), src - gap, src)
    for _ in range(64):  # chase chains (geometric, quickly exhausted)
        need = replay[src] & (src >= gap)
        if not need.any():
            break
        src = np.where(need, src - gap, src)
    addrs = addrs[src][:n]
    is_write = rng.random(n) < spec.write_frac
    is_write = np.where(replay[:n], False, is_write)  # replays are reads
    return addrs, is_write
