#!/usr/bin/env python3
"""Time two source trees' flat-search and string-match kernels in turns.

    python3 tools/torch_kernel_ab.py --old DIR [--json FILE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The script builds that tree's
``kernels/xam_search/csrc/xam_search.cu`` and
``kernels/string_match/csrc/string_match.cu`` beside this tree's, with this
tree's ``kernels/build.py`` (the launchers' C signatures are the same),
holds every library exactly against the plain versions, and times them on
one CUDA card in turns old, new, new, old at the main paths' shapes:
``chip_smoke.CudaTimer.graph_ms`` (CUDA-graph replay, cold L2).  It also
times this tree's empty kernel, the launch floor.  One JSON line per
shape; with ``--json`` the whole report is written there too.  Needs a
card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAT_SRC = "src/repro_torch/kernels/xam_search/csrc/xam_search.cu"
SM_SRC = "src/repro_torch/kernels/string_match/csrc/string_match.cu"
CORPUS_BYTES = 500 * 2 ** 20
FLAT_SHAPES = [("Fig. 6", (1, 64, 512)), ("dedup", (4096, 32, 65536))]
SM_CASES = [("P=12", 12, False), ("P=1", 1, False), ("P=4096", 4096, False),
            ("repeated byte, P=64", 64, True)]


def load(src: pathlib.Path, prefix: str):
    from repro_torch.kernels import build
    kl = build.compile_and_load(src, prefix)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if prefix == "xam_search":
        kl.lib.xam_search_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        kl.lib.xam_search_launch.restype = ci
    else:
        kl.lib.string_match_launch.argtypes = [vp] * 3 + [ctypes.c_long, ci,
                                                          vp]
        kl.lib.string_match_launch.restype = ci
    return kl


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--json", type=pathlib.Path)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import HBM_BYTES_PER_S, CudaTimer, nvidia_smi
    from repro_torch.apps.stringmatch import make_corpus
    from repro_torch.kernels.build import stream_of
    from repro_torch.kernels.string_match.ref import string_match_plain
    from repro_torch.kernels.xam_search.ops import pack_rows
    from repro_torch.kernels.xam_search.ref import xam_search_plain

    jobs = {("old", "xam_search"): args.old / FLAT_SRC,
            ("new", "xam_search"): ROOT / FLAT_SRC,
            ("old", "string_match"): args.old / SM_SRC,
            ("new", "string_match"): ROOT / SM_SRC}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda kv: load(kv[1], kv[0][1]),
                                     jobs.items())))
    for (tree, name), kl in libs.items():
        print(f"# {tree} {name}: {kl.path.name} built in "
              f"{kl.build_seconds:.2f} s; {kl.ptxas_lines()}", flush=True)

    smi = nvidia_smi()
    timer = CudaTimer(torch)
    rows = []

    def turns(shape, fns, n_bytes, reps):
        """old, new, new, old; each equal to the plain version first."""
        t = {"old": [], "new": []}
        for tree in ("old", "new", "new", "old"):
            t[tree].append(timer.graph_ms(fns[tree], reps=reps))
        row = {"shape": shape, "old_ms": t["old"], "new_ms": t["new"],
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "bytes": int(n_bytes), "card": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)

    floor = libs[("new", "xam_search")]
    floor.lib.xam_search_floor_launch.argtypes = [ctypes.c_void_p]
    rows.append({"shape": "empty kernel (launch floor)", "new_ms": [
        timer.graph_ms(lambda: floor.check(floor.lib.xam_search_floor_launch(
            torch.cuda.current_stream().cuda_stream)), reps=100)
        for _ in range(2)],
        "card": smi})
    print(json.dumps(rows[-1]), flush=True)

    rng = np.random.default_rng(0)
    for name, (q, r, c) in FLAT_SHAPES:
        keys = torch.from_numpy(rng.integers(0, 2, (q, r)).astype(np.int8))
        data = torch.from_numpy(rng.integers(0, 2, (r, c)).astype(np.int8))
        k, m, d = keys.cuda(), torch.ones_like(keys).cuda(), data.cuda()
        for packed in (False, True):
            dd = pack_rows(d) if packed else d
            out = {t: torch.empty((q, c), dtype=torch.int8, device="cuda")
                   for t in ("old", "new")}

            def fn(tree, dd=dd, out=out):
                kl = libs[(tree, "xam_search")]
                return lambda: kl.check(kl.lib.xam_search_launch(
                    k.data_ptr(), m.data_ptr(), dd.data_ptr(),
                    out[tree].data_ptr(), q, r, dd.shape[0], c,
                    int(packed), stream_of(dd)))
            fns = {t: fn(t) for t in ("old", "new")}
            want = xam_search_plain(k, dd, m)
            for t in fns:
                fns[t]()
                torch.cuda.synchronize()
                if not torch.equal(out[t], want):
                    raise AssertionError(f"{t} flat search != plain at {name}")
            fmt = "packed8" if packed else "int8"
            turns(f"flat search {name} {q} x {r} x {c} ({fmt})", fns,
                  2 * q * r + dd.numel() + q * c, 5 if q > 1 else 100)
        del k, m, d, out

    corpus = torch.from_numpy(make_corpus(CORPUS_BYTES, seed=0)).cuda()
    n = corpus.shape[0]
    for name, p, repeated in SM_CASES:
        text = (torch.full((n,), 97, dtype=torch.uint8, device="cuda")
                if repeated else corpus)
        pat = text[n // 4 + 1:n // 4 + 1 + p].clone()
        out = {t: torch.empty(n, dtype=torch.int8, device="cuda")
               for t in ("old", "new")}

        def fn(tree, text=text, pat=pat, out=out):
            kl = libs[(tree, "string_match")]
            return lambda: kl.check(kl.lib.string_match_launch(
                text.data_ptr(), pat.data_ptr(), out[tree].data_ptr(), n, p,
                stream_of(text)))
        fns = {t: fn(t) for t in ("old", "new")}
        want = string_match_plain(text, pat)
        for t in fns:
            fns[t]()
            torch.cuda.synchronize()
            if not torch.equal(out[t], want):
                raise AssertionError(f"{t} string match != plain at {name}")
        turns(f"string match 500 MiB, {name}", fns, 2 * n + p, 5)
        del out, want
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": smi, "rows": rows},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
