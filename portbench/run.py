"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for (``BENCHMARK.json``), and prints one JSON line last: whether
the served answers were correct, the cell's metrics (end-to-end with
``--trace 0``, per layer with ``--trace 1``), the device, and the
numbers the check compared beside their limits.  Without the cards it
exits with 2 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import main as bench, spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = bench.measure(cell, args.seed, args.seconds, bool(args.trace),
                           t0=T0)
    found = bench.banned_modules()
    if found:
        print(f"refusing to report: {found} loaded", file=sys.stderr)
        return 3
    bench.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
