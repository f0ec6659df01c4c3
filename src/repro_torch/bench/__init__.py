"""Benchmark runtime subsystem of the port: timing harness +
machine-readable emission (port of ``repro/bench/``).

``harness`` — warmup + median-of-k wall timing for callables returning
tensors (every card holding one is synchronised), a stopwatch for one-shot
sweeps, and the quick/full size policy.
``emit`` — ``BENCH_<name>.json`` artifact files with run metadata: the
device, the card's name and power limit, the machine profile and the
autotune cache fingerprint.
"""
from repro_torch.bench.emit import bench_out_dir, emit_json
from repro_torch.bench.harness import (BenchSizes, Timing, stopwatch,
                                       time_callable, time_interleaved)

__all__ = [
    "BenchSizes", "Timing", "bench_out_dir", "emit_json", "stopwatch",
    "time_callable", "time_interleaved",
]
