"""Measured block shapes for the XAM search kernels (port of
``repro/kernels/autotune.py``).

The fused multi-set search: the host packs a lookup batch into per-set
blocks of ``block_q`` queries (``xam_search/ops.py``
``group_queries_by_set``) and the kernel gives each block to one thread
block.  The flat search (the Fig. 6 API, ``dedup_mask``): a thread block
covers ``block_q`` queries by ``block_c`` columns of its (Q, C) bitmap.
A small sweep (:func:`autotune`, or ``python -m
repro_torch.kernels.autotune --out <file>`` on the card) times the
candidates per family on the batches the path sends and writes the
choices to a cache file; the committed one is ``autotune_cache.json``
beside this module.

A *family* is ``{kernel}/{backend}/{plane_format}/{shape_bucket}``:

* ``kernel`` — ``xam_multiset`` (tunes ``block_q``) or ``xam_search``
  (tunes the pair ``(block_q, block_c)``);
* ``backend`` — ``cpu`` for host tensors, ``cuda:<device name>`` for
  the card that holds the planes, so a shape measured on one card never
  steers another;
* ``plane_format`` — ``int8`` / ``packed8`` (``kernels/common.py``);
* ``shape_bucket`` — for ``xam_multiset`` ``narrow`` below
  ``WIDE_BLOCK_AT`` queries, ``wide`` at or above; for ``xam_search``
  ``small`` where the cold pair narrows its blocks to cover the card's
  SMs and ``large`` where it does not (:func:`search_bucket`).  Every
  batch in a bucket gets ONE shape, cache hit or not.

Misses fall back DETERMINISTICALLY to the launch shapes used before the
sweep existed: the multi-set search's two-point constants (16 below 256
queries, 64 at or above), the flat search's cold pair
(``xam_search/kernel.py`` ``flat_geometry``, a function of Q and C).  So
a cold cache (a missing or unreadable file, an unknown card, any CPU run
against the committed file) launches exactly as before.  A shape never
changes an answer (first valid way per query; every query's full bitmap),
only its speed.  ``REPRO_TORCH_AUTOTUNE_CACHE`` points the loader at
another file; the reference's ``REPRO_AUTOTUNE_CACHE`` does not steer the
port.

Where the port's sweep differs from the reference's: on the card it takes
the kernel's DEVICE time (a CUDA graph of ``GRAPH_CALLS`` launches,
replayed between two CUDA events), since the host wall time around a
kernel of a few microseconds is mostly launch and synchronisation; it
times each bucket at the batch shapes the serving path sends
(``BUCKET_SHAPES``), not at one synthetic size; and a candidate replaces
the cold width only where its replays' upper quartile lies under the cold
width's lower quartile, less ``MIN_GAIN``, on every shape of the bucket,
so a near tie keeps the cold width and one slow replay does not decide.  The flat search's
buckets replace the reference's one ``default`` bucket: on the card one
fixed pair cannot serve a 512-column search, which needs narrow blocks to
reach the SMs, and a 65,536-column one; and its cold pair is not one
constant but ``flat_geometry`` at each shape, so a candidate pair is held
against the cold pair of each shape of the bucket, and a bucket where no
pair wins on every shape records an explicit cold entry.  The block-c
candidates add 1024 to the reference's (128, 256, 512): the cold pair
takes it at the dedup shape.
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
from repro_torch.kernels.xam_search.kernel import (FLAT_BLOCK_C,
                                                   FLAT_MAX_GRID_Y,
                                                   flat_geometry)

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

#: Sweep candidates: ``block_q`` for both searches, ``block_c`` for the
#: flat one (every column block its launcher takes).
BLOCK_Q_CANDIDATES = (8, 16, 32, 64, 128)
BLOCK_C_CANDIDATES = FLAT_BLOCK_C

#: The batches the serving path sends, per shape bucket, as (sets,
#: queries): a lookup of two 96-token prompts and the serve launcher's
#: batch below ``WIDE_BLOCK_AT``; ``KVIndexConfig``'s defaults and a
#: one-card index of 65,536 slots at or above it.
BUCKET_SHAPES = {"narrow": ((8, 12), (8, 96)),
                 "wide": ((32, 256), (128, 4096))}

#: The flat search's shapes, per shape bucket, as (Q, R, C): ``small``
#: holds the Fig. 6 search of one key against one Monarch set, which the
#: path sends, and the reference's sweep shape of 64 keys, which no path
#: of the port sends; ``large`` holds ``dedup_mask``'s 4096 fingerprints
#: against 65,536 columns, which the path sends.
SEARCH_SHAPES = {"small": ((1, 64, 512), (64, 64, 512)),
                 "large": ((4096, 32, 65536),)}

#: The least gain a candidate must show over the cold key, as a share of
#: the cold key's lower quartile: sweeps in separate calls on the card
#: read the dedup search's cold pair about 1% apart, so a smaller win is
#: not one that a second sweep would repeat.
MIN_GAIN = 0.02

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


def search_bucket(q: int, c: int) -> str:
    """The flat search's shape bucket of a (Q, R) x (R, C) search:
    ``small`` where the cold pair narrows its blocks to cover the SMs,
    ``large`` where it takes the widest."""
    return "small" if flat_geometry(q, c)[1] < FLAT_BLOCK_C[-1] else "large"


def search_blocks(q: int, c: int, plane_format: str = "int8",
                  device: str | torch.device | None = None
                  ) -> tuple[int, int]:
    """Measured ``(block_q, block_c)`` for the flat search of ``q``
    queries over ``c`` columns on ``device`` (None: the card if there is
    one), deterministic per (shape bucket, plane format): the cached pair
    when the family holds one, else ``flat_geometry(q, c)``, as on the
    CPU, whose plain version takes no pair.  A cached ``block_q`` is
    widened where ``q`` would need more query blocks than the launcher's
    grid takes (``FLAT_MAX_GRID_Y``), as ``flat_geometry`` widens its own;
    the answer is the same at any width."""
    plane_format = resolve_plane_format(plane_format)
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        fam = _families().get(family_key(
            "xam_search", plane_format, search_bucket(q, c), dev))
        if isinstance(fam, dict) and fam.get("block_q") is not None:
            return (max(int(fam["block_q"]), -(-q // FLAT_MAX_GRID_Y)),
                    int(fam["block_c"]))
    return flat_geometry(q, c)


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


def search_workload(q: int, r: int, c: int, plane_format: str,
                    device: str | torch.device):
    """The flat sweep's operands (numpy generator seeded 0): (Q, R) keys,
    full masks and an (R, C) plane, packed for ``packed8``, on ``device``:
    the arguments of ``ops.xam_search_device`` in order."""
    import numpy as np

    from repro_torch.kernels.xam_search import ops as xam_ops

    rng = np.random.default_rng(0)
    dev = torch.device(device)
    keys = torch.from_numpy(rng.integers(0, 2, (q, r)).astype(np.int8))
    data = torch.from_numpy(rng.integers(0, 2, (r, c)).astype(np.int8))
    if plane_format == "packed8":
        data = xam_ops.pack_rows(data)
    return keys.to(dev), data.to(dev), torch.ones_like(keys).to(dev)


def _time_search(q: int, r: int, c: int, blocks: tuple[int, int],
                 plane_format: str, reps: int,
                 device: torch.device) -> list[float]:
    """Per-rep us of one flat search of the sweep's operands at the pair
    ``blocks``: device time by graph replay on the card, wall time on the
    host (where the plain version ignores the pair)."""
    from repro_torch.kernels.xam_search import ops as xam_ops

    operands = search_workload(q, r, c, plane_format, device)
    fn = lambda: xam_ops.xam_search_device(*operands, blocks=blocks)
    return (_graph_us(fn, reps) if device.type == "cuda"
            else _wall_us(fn, reps))


def _quartiles(t: list[float]) -> list[float]:
    """Lower quartile, median and upper quartile of the reps."""
    return statistics.quantiles(t, n=4, method="inclusive")


def _choose(times: dict, cold):
    """The cold key, unless some candidate is faster on every shape of the
    bucket beyond the spread of the reps and by ``MIN_GAIN`` (its upper
    quartile under ``1 - MIN_GAIN`` of the cold key's lower quartile);
    then the least sum of medians among those.
    ``times`` maps each key (a width, or a ``(block_q, block_c)`` pair) to
    its per-shape reps; the cold key's reps may be another launch shape on
    each shape (the flat search's ``flat_geometry``)."""
    faster = [k for k, per_shape in times.items() if all(
        _quartiles(t)[2] < (1 - MIN_GAIN) * _quartiles(c)[0]
        for t, c in zip(per_shape, times[cold]))]
    if not faster:
        return cold
    return min(faster, key=lambda k: sum(
        statistics.median(t) for t in times[k]))


def _swept(times: dict) -> dict:
    """Each key's quartiles on each shape, rounded to ns."""
    return {str(k): dict(zip(("q1_us", "median_us", "q3_us"), zip(
        *([round(v, 3) for v in _quartiles(t)] for t in per_shape))))
        for k, per_shape in times.items()}


def _sweep_search(plane_format: str, reps: int, dev: torch.device,
                  backend: str) -> dict:
    """The flat search's families of one plane format: every candidate
    pair (keyed ``"8x128"``) and the cold pair (``"cold"``,
    ``flat_geometry`` of each shape) timed on each shape of the bucket
    (``SEARCH_SHAPES``)."""
    pairs = {"cold": None, **{f"{bq}x{bc}": (bq, bc)
                              for bq in BLOCK_Q_CANDIDATES
                              for bc in BLOCK_C_CANDIDATES}}
    families = {}
    for bucket, shapes in SEARCH_SHAPES.items():
        times = {name: [_time_search(
            q, r, c, pair or flat_geometry(q, c), plane_format, reps, dev)
            for q, r, c in shapes] for name, pair in pairs.items()}
        best = pairs[_choose(times, "cold")] or (None, None)
        families[f"xam_search/{backend}/{plane_format}/{bucket}"] = {
            "block_q": best[0], "block_c": best[1],
            "shapes": [list(s) for s in shapes],
            "cold": [list(flat_geometry(q, c)) for q, _, c in shapes],
            "swept": _swept(times),
        }
    return families


def autotune(out_path: pathlib.Path | str | None = None,
             quick: bool = False,
             device: str | torch.device = "cuda") -> dict:
    """Sweep every family on ``device`` and write the choices.

    Returns the cache payload (also written to ``out_path``, default the
    committed ``autotune_cache.json``).  Each family records every
    candidate's quartiles on each of its bucket's shapes
    (``BUCKET_SHAPES``, ``SEARCH_SHAPES``), and what :func:`_choose` took:
    a multi-set family its width, a flat family its pair, or null for the
    cold pair, whose own quartiles stand under ``"cold"``."""
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
                "swept": _swept(times),
            }
        families.update(_sweep_search(plane_format, reps, dev, backend))
    payload = {
        "version": 1,
        "backend": backend,
        "timing": ("device, CUDA-graph replay" if dev.type == "cuda"
                   else "host wall"),
        "reps": reps,
        "block_q_candidates": list(BLOCK_Q_CANDIDATES),
        "block_c_candidates": list(BLOCK_C_CANDIDATES),
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
        flat = key.startswith("xam_search/")
        for k, t in fam["swept"].items():
            print(f"[autotune] {key} {'pair' if flat else 'block_q'} "
                  f"{k:>7}: median {t['median_us']} us (quartiles "
                  f"{t['q1_us']}, {t['q3_us']}) at "
                  f"{'(Q, R, C)' if flat else '(sets, queries)'} "
                  f"{fam['shapes']}")
        if flat:
            print(f"[autotune] {key}: block_q={fam['block_q']} block_c="
                  f"{fam['block_c']} (null: the cold pairs {fam['cold']})")
        else:
            print(f"[autotune] {key}: block_q={fam['block_q']} (cold "
                  f"{fam['cold_block_q']})")
    path = pathlib.Path(args.out) if args.out else DEFAULT_CACHE_PATH
    print(f"[autotune] wrote {path} (fingerprint {_fingerprint(path)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
