"""Readings a cell's correctness limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds 4 \\
        --seeds 11 12 ... --control 4

For each seed: the cell's set-up and a short window at its own load, as
a run makes them, then the numbers the check compares (the lower
readings: the program's sound runs).  For the first ``--control``
seeds also the control: the float32 reference put in the program's
place at the next precision down (fp8 e4m3 products), read as the gap
of the token it puts first at each position of the same prompts and
served tokens (the upper readings).  One JSON line a seed, then one
with the extremes.  The benchmark's own runs never run the control.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import spec
    from portbench.lib.cell import Harness
    cell = spec.load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    program, control = [], []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        h = Harness(cell, seed, args.device)
        h.setup()
        run = h.window(args.seconds, False, time.perf_counter() - t0)
        h.release()
        t1 = time.perf_counter()
        checks = h.check(run)
        line = {"seed": seed, "setup_s": run.setup_s,
                "requests": sum(b.rows for b in run.batches),
                "hit_mismatch": checks["hit_mismatch"]["value"],
                "max_gap": checks["max_gap"]["value"],
                "check_s": time.perf_counter() - t1}
        program.append(line["max_gap"])
        if i < args.control:
            t2 = time.perf_counter()
            _, line["control_max_gap"] = h.gaps(run, control=True)
            line["control_s"] = time.perf_counter() - t2
            control.append(line["control_max_gap"])
        print(json.dumps(line), flush=True)
        del h, run
    print(json.dumps({"workload": args.workload, "seeds": len(program),
                      "program_max_gap_max": max(program),
                      "control_max_gap_min": min(control) if control
                      else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
