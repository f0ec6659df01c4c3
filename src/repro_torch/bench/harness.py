"""Timing harness: warmup + median-of-k, stopwatches, quick/full sizing
(port of ``repro/bench/harness.py``).

Compile and first-touch costs are excluded by explicit warmup reps, CUDA's
asynchronous launches are closed out by synchronising every card that
holds a tensor of the result, and the median (not the mean) is reported
so one scheduler hiccup cannot move a tracked number.  These are host
wall times: around a kernel of a few microseconds they are mostly launch
and synchronisation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time

import torch

from repro_torch.pytree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Timing:
    """One measured callable: all values in microseconds."""
    median_us: float
    best_us: float
    mean_us: float
    reps: int
    warmup: int

    @property
    def median_s(self) -> float:
        return self.median_us / 1e6

    def row(self) -> str:
        return f"{self.median_us:.0f}"


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out``: nested dicts,
    dataclasses, lists and tuples are walked, anything else is a host
    object."""
    for leaf in tree_leaves(out):
        if isinstance(leaf, (list, tuple)):
            for item in leaf:
                _cuda_devices(item, found)
        elif torch.is_tensor(leaf) and leaf.device.type == "cuda":
            found.add(leaf.device)
    return found


def _block(out) -> None:
    """Wait until every card that holds a tensor of ``out`` is done; CPU
    tensors and host objects need nothing.

    Whatever the synchronisation raises (a device fault surfacing at the
    sync) propagates: a bench that swallowed it would report the launch
    time of a computation that never produced its result."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


def time_callable(fn, *, warmup: int = 1, reps: int = 5) -> Timing:
    """Median-of-``reps`` wall time of ``fn()`` after ``warmup`` unmeasured
    calls (which absorb kernel builds and first-touch caches)."""
    for _ in range(warmup):
        _block(fn())
    samples = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = fn()
        _block(out)
        samples.append((time.perf_counter() - t0) * 1e6)
    return Timing(
        median_us=statistics.median(samples),
        best_us=min(samples),
        mean_us=statistics.fmean(samples),
        reps=len(samples),
        warmup=warmup,
    )


def time_interleaved(fns, *, warmup: int = 1,
                     reps: int = 5) -> list[Timing]:
    """Round-robin single-call timing of several callables: rep ``k``
    times each ``fn`` in turn instead of finishing one before starting
    the next.  On a shared host a slow phase then lands on EVERY callable
    rather than whichever one happened to be mid-phase, so the RELATIVE
    ordering of the returned medians is trustworthy even when the
    absolute numbers are inflated.  Use for gated A/B comparisons where
    cross-phase noise exceeds the effect size."""
    for fn in fns:
        for _ in range(warmup):
            _block(fn())
    samples: list[list[float]] = [[] for _ in fns]
    for _ in range(max(reps, 1)):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            _block(fn())
            samples[i].append((time.perf_counter() - t0) * 1e6)
    return [Timing(
        median_us=statistics.median(s),
        best_us=min(s),
        mean_us=statistics.fmean(s),
        reps=len(s),
        warmup=warmup,
    ) for s in samples]


@contextlib.contextmanager
def stopwatch(record: dict, key: str):
    """One-shot wall timing for sweeps too big to repeat: stores elapsed
    seconds into ``record[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record[key] = round(time.perf_counter() - t0, 3)


@dataclasses.dataclass(frozen=True)
class BenchSizes:
    """The quick (CI smoke) vs full (paper figure) size policy, in one
    place instead of scattered per-module constants."""
    quick: bool = False

    @property
    def fig_requests(self) -> int:
        """Trace length for the Fig. 9/10/11 sweeps."""
        return 40_000 if self.quick else 120_000

    @property
    def kernel_reps(self) -> int:
        return 3 if self.quick else 5

    @property
    def systems(self) -> list[str] | None:
        """Config subset for the cache sweep (None = all §10.2 systems).
        Quick mode keeps the C1-C4 claim set: the D-Cache baselines plus
        the full Monarch M-sweep."""
        if not self.quick:
            return None
        return ["d_cache", "d_cache_ideal", "monarch_unbound",
                "monarch_m1", "monarch_m2", "monarch_m3", "monarch_m4"]
