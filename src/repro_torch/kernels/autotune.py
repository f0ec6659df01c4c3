"""Measured query-block width for the fused multi-set XAM search (port of
``repro/kernels/autotune.py``).

The host packs a lookup batch into per-set blocks of ``block_q`` queries
(``xam_search/ops.py`` ``group_queries_by_set``) and the kernel gives
each block to one thread block.  A small sweep (:func:`autotune`, or
``python -m repro_torch.kernels.autotune --out <file>`` on the card)
times the candidate widths per family on the batches the serving path
sends and writes the choices to a cache file; the committed one is
``autotune_cache.json`` beside this module.

A *family* is ``xam_multiset/{backend}/{plane_format}/{shape_bucket}``:

* ``backend`` — ``cpu`` for host tensors, ``cuda:<device name>`` for
  the card that holds the planes, so a width measured on one card never
  steers another;
* ``plane_format`` — ``int8`` / ``packed8`` (``kernels/common.py``);
* ``shape_bucket`` — ``narrow`` below ``WIDE_BLOCK_AT`` queries, ``wide``
  at or above: every batch in a bucket gets ONE width, cache hit or not.

Misses fall back DETERMINISTICALLY to the two-point constants (16 below
256 queries, 64 at or above), so a cold cache (a missing or unreadable
file, an unknown card, any CPU run against the committed file) gives
exactly the widths used before the sweep existed.  The width never
changes an answer (first valid way per query), only its speed.
``REPRO_TORCH_AUTOTUNE_CACHE`` points the loader at another file; the
reference's ``REPRO_AUTOTUNE_CACHE`` does not steer the port.

Where the port's sweep differs from the reference's: on the card it takes
the kernel's DEVICE time (a CUDA graph of ``GRAPH_CALLS`` launches,
replayed between two CUDA events), since the host wall time around a
kernel of a few microseconds is mostly launch and synchronisation; it
times each bucket at the batch shapes the serving path sends
(``BUCKET_SHAPES``), not at one synthetic size; and a candidate replaces
the cold width only where its replays' upper quartile lies under the cold
width's lower quartile on every shape of the bucket, so a near tie keeps
the cold width and one slow replay does not decide.

Not ported: the reference's ``xam_search`` family and ``search_blocks``.
The flat search's CUDA kernel has compile-time tiles and no run-time
``block_q``/``block_c``, so a cached pair would steer nothing.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import pathlib
import statistics
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import resolve_plane_format

#: Committed choices; regenerate with ``python -m
#: repro_torch.kernels.autotune --out <file>`` on the card.
DEFAULT_CACHE_PATH = pathlib.Path(__file__).with_name("autotune_cache.json")

#: Env knob pointing the loader at an alternate cache file.
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

#: The shape-bucket split of the families AND the fallback's switch
#: point: ``MULTISET_BLOCK_Q`` below it, ``WIDE_BLOCK_Q`` at or above.
MULTISET_BLOCK_Q = 16
WIDE_BLOCK_AT = 256
WIDE_BLOCK_Q = 64

#: Sweep candidates.
BLOCK_Q_CANDIDATES = (8, 16, 32, 64, 128)

#: The batches the serving path sends, per shape bucket, as (sets,
#: queries): a lookup of two 96-token prompts and the serve launcher's
#: batch below ``WIDE_BLOCK_AT``; ``KVIndexConfig``'s defaults and a
#: one-card index of 65,536 slots at or above it.
BUCKET_SHAPES = {"narrow": ((8, 12), (8, 96)),
                 "wide": ((32, 256), (128, 4096))}

#: Searches captured in one CUDA graph; a replay's time over this is one
#: search's device time.
GRAPH_CALLS = 20


def cache_path() -> pathlib.Path:
    override = os.environ.get(CACHE_ENV)
    return pathlib.Path(override) if override else DEFAULT_CACHE_PATH


@functools.lru_cache(maxsize=None)
def _load(path_str: str) -> dict:
    """Family table from the cache file; {} when cold/unreadable (the
    deterministic fallback then answers every query)."""
    path = pathlib.Path(path_str)
    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return {}
    fams = data.get("families", {}) if isinstance(data, dict) else {}
    return fams if isinstance(fams, dict) else {}


def _families() -> dict:
    return _load(str(cache_path()))


def reset_cache() -> None:
    """Drop the in-process loader cache (tests repoint the cache file and
    need the next consult to re-read)."""
    _load.cache_clear()


@functools.lru_cache(maxsize=None)
def _backend(device: torch.device) -> str:
    """``cpu``, or ``cuda:<device name>``: resolved once per device, since
    the lookup runs on the host side of every search."""
    if device.type == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name(device)}"


def family_key(kernel: str, plane_format: str, shape_bucket: str,
               device: str | torch.device = "cuda") -> str:
    return (f"{kernel}/{_backend(torch.device(device))}/{plane_format}/"
            f"{shape_bucket}")


def cold_block_q(n_queries: int) -> int:
    """The width a cold cache gives ``n_queries``."""
    return WIDE_BLOCK_Q if n_queries >= WIDE_BLOCK_AT else MULTISET_BLOCK_Q


def multiset_block_q(n_queries: int, plane_format: str = "int8",
                     device: str | torch.device = "cuda") -> int:
    """Measured ``block_q`` for the fused multi-set search over planes on
    ``device``, deterministic per (shape bucket, plane format): the cached
    winner when the family is cached, else the two-point constants."""
    plane_format = resolve_plane_format(plane_format)
    wide = n_queries >= WIDE_BLOCK_AT
    fam = _families().get(family_key(
        "xam_multiset", plane_format, "wide" if wide else "narrow", device))
    if fam is not None:
        return int(fam["block_q"])
    return cold_block_q(n_queries)


def cache_fingerprint() -> str:
    """Short content hash of the active cache file — stamped into every
    ``BENCH_*.json`` so cross-run comparisons can't silently mix tuned
    and untuned (or differently tuned) configurations.  ``"cold"`` when
    the file is absent."""
    path = cache_path()
    if not path.exists():
        return "cold"
    return _fingerprint(path)


def _fingerprint(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# The sweep.
# ---------------------------------------------------------------------------

def multiset_workload(n_sets: int, n_q: int, block_q: int,
                      plane_format: str, device: str | torch.device):
    """The sweep's synthetic batch (numpy generator seeded 0: ``n_sets``
    sets, 32-bit keys, 512 ways, ``n_q`` queries), packed at ``block_q``
    on ``device``.  Returns ``(operands, slot)``: the arguments of
    ``ops.xam_search_multiset_device`` in order, and each query's row in
    its result."""
    import numpy as np

    from repro_torch.kernels.common import pack_bits_np
    from repro_torch.kernels.xam_search import ops as xam_ops

    rng = np.random.default_rng(0)
    r, c = 32, 512
    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    if plane_format == "packed8":
        planes = pack_bits_np(planes, axis=1)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    set_ids = rng.integers(0, n_sets, n_q)
    key_bits = xam_ops.words_to_bits_np(
        rng.integers(0, 2 ** 32, n_q, dtype=np.uint32), r)
    keys, masks, block_sets, live, slot = xam_ops.pack_multiset_batch(
        key_bits, set_ids, n_sets, block_q)
    dev = torch.device(device)
    operands = tuple(torch.from_numpy(a).to(dev) for a in (
        keys, masks, planes, valid, block_sets, live))
    return operands, slot


def _graph_us(fn, reps: int) -> list[float]:
    """Device time of one call of ``fn`` in us, once per replay:
    ``GRAPH_CALLS`` calls captured in one CUDA graph, each replay timed by
    CUDA events and divided by ``GRAPH_CALLS``.  Host time (the wrapper,
    the launch) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / GRAPH_CALLS)
    return out


def _wall_us(fn, reps: int) -> list[float]:
    """Wall time of each of ``reps`` calls of ``fn`` in us, after one
    warmup call: on the host, the wall time is the device time."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    return out


def _time_multiset(n_sets: int, n_q: int, block_q: int, plane_format: str,
                   reps: int, device: torch.device) -> list[float]:
    """Per-rep us of one search of the sweep's batch at a candidate
    ``block_q``: device time by graph replay on the card, wall time on
    the host."""
    from repro_torch.kernels.xam_search import ops as xam_ops

    operands, _ = multiset_workload(n_sets, n_q, block_q, plane_format,
                                    device)
    fn = lambda: xam_ops.xam_search_multiset_device(*operands,
                                                    block_q=block_q)
    return (_graph_us(fn, reps) if device.type == "cuda"
            else _wall_us(fn, reps))


def _quartiles(t: list[float]) -> list[float]:
    """Lower quartile, median and upper quartile of the reps."""
    return statistics.quantiles(t, n=4, method="inclusive")


def _choose(times: dict[int, list[list[float]]], cold: int) -> int:
    """The cold width, unless some candidate is faster on every shape of
    the bucket beyond the spread of the reps (its upper quartile under
    the cold width's lower quartile); then the least sum of medians among
    those."""
    faster = [bq for bq, per_shape in times.items() if all(
        _quartiles(t)[2] < _quartiles(c)[0]
        for t, c in zip(per_shape, times[cold]))]
    if not faster:
        return cold
    return min(faster, key=lambda bq: sum(
        statistics.median(t) for t in times[bq]))


def autotune(out_path: pathlib.Path | str | None = None,
             quick: bool = False,
             device: str | torch.device = "cuda") -> dict:
    """Sweep every family on ``device`` and write the choices.

    Returns the cache payload (also written to ``out_path``, default the
    committed ``autotune_cache.json``).  Each family records every
    candidate's quartiles on each of its bucket's shapes
    (``BUCKET_SHAPES``), and the width :func:`_choose` took."""
    dev = resolve_device(device)
    reps = 5 if quick else 15
    backend = _backend(dev)
    families: dict[str, dict] = {}
    for plane_format in ("int8", "packed8"):
        for bucket, shapes in BUCKET_SHAPES.items():
            times = {bq: [_time_multiset(n_sets, n_q, bq, plane_format,
                                         reps, dev)
                          for n_sets, n_q in shapes]
                     for bq in BLOCK_Q_CANDIDATES}
            cold = cold_block_q(shapes[0][1])
            best = _choose(times, cold)
            families[f"xam_multiset/{backend}/{plane_format}/{bucket}"] = {
                "block_q": best,
                "cold_block_q": cold,
                "shapes": [list(s) for s in shapes],
                "swept": {str(bq): dict(zip(
                    ("q1_us", "median_us", "q3_us"),
                    zip(*([round(v, 3) for v in _quartiles(t)]
                          for t in per_shape))))
                    for bq, per_shape in times.items()},
            }
    payload = {
        "version": 1,
        "backend": backend,
        "timing": ("device, CUDA-graph replay" if dev.type == "cuda"
                   else "host wall"),
        "reps": reps,
        "block_q_candidates": list(BLOCK_Q_CANDIDATES),
        "families": families,
    }
    path = pathlib.Path(out_path) if out_path else DEFAULT_CACHE_PATH
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    reset_cache()
    return payload


def main(argv: list[str] | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="5 reps instead of 15")
    p.add_argument("--out", default=None,
                   help="cache file to write (default: the committed one)")
    p.add_argument("--device", default="cuda",
                   help="device holding the planes (default: the card)")
    args = p.parse_args(argv)
    payload = autotune(args.out, quick=args.quick, device=args.device)
    for key in sorted(payload["families"]):
        fam = payload["families"][key]
        for bq, t in sorted(fam["swept"].items(), key=lambda kv: int(kv[0])):
            print(f"[autotune] {key} block_q {int(bq):3d}: median "
                  f"{t['median_us']} us (quartiles {t['q1_us']}, "
                  f"{t['q3_us']}) at (sets, queries) {fam['shapes']}")
        print(f"[autotune] {key}: block_q={fam['block_q']} (cold "
              f"{fam['cold_block_q']})")
    path = pathlib.Path(args.out) if args.out else DEFAULT_CACHE_PATH
    print(f"[autotune] wrote {path} (fingerprint {_fingerprint(path)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
