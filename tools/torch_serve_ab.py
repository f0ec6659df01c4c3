#!/usr/bin/env python3
"""Time two source trees' yi-9b serving stages in turns.

    python3 tools/torch_serve_ab.py --old DIR [--pairs N] [--json FILE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each run is a fresh process that imports one
tree's ``chip_smoke.py``, builds that tree's kernels and runs its phase 3,
``serve_phase``: yi-9b at full width and depth served through the Monarch
index on one card, then its per-stage times (prefill full and resumed,
decode per token, lookup, admission; host clock ending in a
synchronisation).  Runs go in turns old, new, new, old, ... for
``--pairs`` pairs, so drift on the shared host falls on both trees alike.
One JSON line per run, then the per-tree medians; with ``--json`` the
whole report is written there too.  Needs a card; exits non-zero without
one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
_CHILD = """
import json, sys
root = sys.argv[1]
sys.path.insert(0, root + "/src"); sys.path.insert(0, root)
import numpy as np, torch
if not torch.cuda.is_available():
    sys.exit(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
import chip_smoke
chip_smoke.build_all()
times = chip_smoke.serve_phase(np, torch)["times"]
print("SERVE_AB " + json.dumps(times), flush=True)
"""


def run(root: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(root)],
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("SERVE_AB "):
            return json.loads(line[len("SERVE_AB "):])
    raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--json", type=pathlib.Path)
    args = ap.parse_args()
    trees = {"old": args.old.resolve(), "new": ROOT}
    order = [("old", "new") if i % 2 == 0 else ("new", "old")
             for i in range(args.pairs)]
    runs = []
    for pair in order:
        for name in pair:
            times = run(trees[name])
            runs.append({"tree": name, **times})
            print(json.dumps(runs[-1]), flush=True)
    keys = [k for k, v in runs[0].items() if isinstance(v, float)]
    medians = {name: {k: statistics.median(r[k] for r in runs
                                           if r["tree"] == name)
                      for k in keys} for name in trees}
    print(json.dumps({"medians": medians}), flush=True)
    if args.json:
        args.json.write_text(json.dumps({"runs": runs, "medians": medians},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
