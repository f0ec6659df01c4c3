#!/usr/bin/env python3
"""Time two source trees' XAM search, hopscotch and string-match kernels in
turns.

    python3 tools/torch_kernel_ab.py --old DIR [--only K[,K]] [--json FILE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The script builds that tree's four kernel sources
(``xam_search.cu``, ``xam_multiset.cu``, ``hopscotch_lookup.cu``,
``string_match.cu``) beside this tree's, with this tree's
``kernels/build.py`` (the launchers' C signatures are the same, but for
the flat search's block pair, which a tree's launcher takes or not: it
gets the cold pair, ``kernel.flat_geometry``, where it does), holds
every library exactly against the plain versions, and times them on one
CUDA card in turns old, new, new, old at the main paths' shapes:
``chip_smoke.CudaTimer.graph_ms`` (CUDA-graph replay, cold L2).  It also
times this tree's empty kernel, the launch floor.  ``--only`` takes a
comma-separated subset of the library prefixes (``xam_search``,
``xam_multiset``, ``hopscotch_lookup``, ``string_match``).  One JSON line
per shape; with ``--json`` the whole report is written there too.  Needs a
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
_K = "src/repro_torch/kernels/"
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
#: Library prefix -> (source under the tree's root, launcher argtypes).
SOURCES = {
    "xam_search": (_K + "xam_search/csrc/xam_search.cu",
                   [_VP] * 4 + [_CI] * 5 + [_VP]),
    "xam_multiset": (_K + "xam_search/csrc/xam_multiset.cu",
                     [_VP] * 7 + [_CI] * 7 + [_VP]),
    "hopscotch_lookup": (_K + "hopscotch/csrc/hopscotch_lookup.cu",
                         [_VP] * 6 + [_CL, _CI, _CI, _VP]),
    "string_match": (_K + "string_match/csrc/string_match.cu",
                     [_VP] * 3 + [_CL, _CI, _VP]),
}
CORPUS_BYTES = 500 * 2 ** 20
FLAT_SHAPES = [("Fig. 6", (1, 64, 512)), ("dedup", (4096, 32, 65536))]
MULTISET_SHAPES = [("main path", 8, 12), ("one-card index", 128, 4096)]
HOP_SHAPES = [(17, 8192, 32), (25, 1 << 20, 4), (25, 1 << 20, 32),
              (25, 1 << 20, 128)]
SM_CASES = [("P=12", 12, False), ("P=1", 1, False), ("P=4096", 4096, False),
            ("repeated byte, P=64", 64, True)]


#: The two signatures a tree's flat launcher may end with (whitespace
#: folded), and whether it takes the block pair: a tree from before the
#: launcher took one has the second.
FLAT_SIGNATURES = {"int packed, int block_q, int block_c, void* stream)": True,
                   "int packed, void* stream)": False}


def takes_pair(root: pathlib.Path) -> bool:
    """Whether ``root``'s flat launcher takes a block pair; exits when its
    signature is neither of ``FLAT_SIGNATURES``."""
    src = " ".join((root / SOURCES["xam_search"][0]).read_text().split())
    found = [pair for sig, pair in FLAT_SIGNATURES.items() if sig in src]
    if len(found) != 1:
        raise SystemExit(f"{root}: the flat launcher's signature is none of "
                         f"{sorted(FLAT_SIGNATURES)}")
    return found[0]


def load(root: pathlib.Path, prefix: str):
    from repro_torch.kernels import build
    src, argtypes = SOURCES[prefix]
    kl = build.compile_and_load(root / src, prefix)
    launch = getattr(kl.lib, f"{prefix}_launch")
    if prefix == "xam_search" and takes_pair(root):
        argtypes = argtypes[:-1] + [_CI, _CI, _VP]
    launch.argtypes = argtypes
    launch.restype = _CI
    return kl


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--only", default=",".join(SOURCES))
    ap.add_argument("--json", type=pathlib.Path)
    args = ap.parse_args()
    kinds = args.only.split(",")
    if not set(kinds) <= set(SOURCES):
        ap.error(f"--only takes prefixes of {sorted(SOURCES)}")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import (CudaTimer, h100, hop_bytes, hop_case,
                            nvidia_smi, search_case)
    from repro_torch.apps.stringmatch import make_corpus
    from repro_torch.kernels.build import stream_of
    from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain
    from repro_torch.kernels.string_match.ref import string_match_plain
    from repro_torch.kernels.xam_search.kernel import flat_geometry
    from repro_torch.kernels.xam_search.ops import pack_rows
    from repro_torch.kernels.xam_search.ref import (xam_search_multiset_plain,
                                                    xam_search_plain)

    jobs = [(tree, prefix) for prefix in kinds for tree in ("old", "new")]
    if "xam_search" not in kinds:
        jobs.append(("new", "xam_search"))            # the empty kernel
    roots = {"old": args.old, "new": ROOT}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda j: load(roots[j[0]], j[1]),
                                     jobs)))
    for (tree, name), kl in libs.items():
        print(f"# {tree} {name}: {kl.path.name} built in "
              f"{kl.build_seconds:.2f} s; {kl.ptxas_lines()}", flush=True)

    smi = nvidia_smi()
    timer = CudaTimer(torch)
    rows = []

    def turns(shape, fns, n_bytes, reps, **extra):
        """old, new, new, old; each equal to the plain version first."""
        t = {"old": [], "new": []}
        for tree in ("old", "new", "new", "old"):
            t[tree].append(timer.graph_ms(fns[tree], reps=reps))
        row = {"shape": shape, "old_ms": t["old"], "new_ms": t["new"],
               "bound_ms": n_bytes / h100().hbm_bw * 1e3,
               "bytes": int(n_bytes), **extra, "card": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def check(fns, out, want, what):
        for tree in fns:
            fns[tree]()
            torch.cuda.synchronize()
            if not torch.equal(out[tree], want):
                raise AssertionError(f"{tree} {what} != plain")

    floor = libs[("new", "xam_search")]
    floor.lib.xam_search_floor_launch.argtypes = [ctypes.c_void_p]
    rows.append({"shape": "empty kernel (launch floor)", "new_ms": [
        timer.graph_ms(lambda: floor.check(floor.lib.xam_search_floor_launch(
            torch.cuda.current_stream().cuda_stream)), reps=100)
        for _ in range(2)],
        "card": smi})
    print(json.dumps(rows[-1]), flush=True)

    rng = np.random.default_rng(0)
    for name, (q, r, c) in FLAT_SHAPES if "xam_search" in kinds else []:
        keys = torch.from_numpy(rng.integers(0, 2, (q, r)).astype(np.int8))
        data = torch.from_numpy(rng.integers(0, 2, (r, c)).astype(np.int8))
        k, m, d = keys.cuda(), torch.ones_like(keys).cuda(), data.cuda()
        for packed in (False, True):
            dd = pack_rows(d) if packed else d
            out = {t: torch.empty((q, c), dtype=torch.int8, device="cuda")
                   for t in ("old", "new")}

            def fn(tree, dd=dd, out=out):
                kl = libs[(tree, "xam_search")]
                pair = flat_geometry(q, c) if takes_pair(roots[tree]) else ()
                return lambda: kl.check(kl.lib.xam_search_launch(
                    k.data_ptr(), m.data_ptr(), dd.data_ptr(),
                    out[tree].data_ptr(), q, r, dd.shape[0], c,
                    int(packed), *pair, stream_of(dd)))
            fns = {t: fn(t) for t in ("old", "new")}
            check(fns, out, xam_search_plain(k, dd, m), f"flat search {name}")
            fmt = "packed8" if packed else "int8"
            turns(f"flat search {name} {q} x {r} x {c} ({fmt})", fns,
                  2 * q * r + dd.numel() + q * c, 5 if q > 1 else 100)
        del k, m, d, out

    for name, n_sets, n_q in (MULTISET_SHAPES if "xam_multiset" in kinds
                              else []):
        for packed in (False, True):
            ops_, bq, n_bytes, _ = search_case(np, torch, rng, n_sets, 32, 512,
                                               n_q, packed=packed)
            keys, masks, planes, valid, bs, live = ops_
            q, rp = keys.shape[0], planes.shape[1]
            out = {t: torch.empty(q, dtype=torch.int32, device="cuda")
                   for t in ("old", "new")}

            def fn(tree, ops_=ops_, out=out, bq=bq, q=q, rp=rp, packed=packed):
                kl = libs[(tree, "xam_multiset")]
                ptrs = [x.data_ptr() for x in ops_]
                return lambda: kl.check(kl.lib.xam_multiset_launch(
                    *ptrs, out[tree].data_ptr(), q // bq, n_sets, bq, 32, rp,
                    512, int(packed), stream_of(keys)))
            fns = {t: fn(t) for t in ("old", "new")}
            check(fns, out, xam_search_multiset_plain(*ops_, block_q=bq),
                  f"multi-set search {name}")
            fmt = "packed8" if packed else "int8"
            turns(f"multi-set search, {name}: {n_sets} sets x {n_q} queries "
                  f"({fmt})", fns, n_bytes, 100 if n_q < 1000 else 20)
            del ops_, out

    for log2_n, n_q, window in (HOP_SHAPES if "hopscotch_lookup" in kinds
                                else []):
        ops_ = hop_case(torch, log2_n, window, n_q, seed=window + log2_n)
        want = hopscotch_lookup_plain(*ops_, window)
        n_bytes, sector_bytes, _ = hop_bytes(torch, ops_, want, window)
        out = {t: torch.empty(n_q, dtype=torch.int32, device="cuda")
               for t in ("old", "new")}

        def fn(tree, ops_=ops_, out=out, window=window, n_q=n_q):
            kl = libs[(tree, "hopscotch_lookup")]
            ptrs = [x.data_ptr() for x in ops_]
            return lambda: kl.check(kl.lib.hopscotch_lookup_launch(
                *ptrs, out[tree].data_ptr(), ops_[0].shape[0], n_q, window,
                stream_of(ops_[0])))
        fns = {t: fn(t) for t in ("old", "new")}
        check(fns, out, want, f"hopscotch 2^{log2_n} H={window}")
        turns(f"hopscotch 2^{log2_n} slots, H={window}, Q={n_q}", fns,
              n_bytes, 20 if n_q <= 8192 else 5,
              sector_bound_ms=sector_bytes / HBM_BYTES_PER_S * 1e3)
        del ops_, out, want

    if "string_match" in kinds:
        corpus = torch.from_numpy(make_corpus(CORPUS_BYTES, seed=0)).cuda()
        n = corpus.shape[0]
    for name, p, repeated in SM_CASES if "string_match" in kinds else []:
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
        check(fns, out, string_match_plain(text, pat), f"string match {name}")
        turns(f"string match 500 MiB, {name}", fns, 2 * n + p, 5)
        del out
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": smi, "rows": rows},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
