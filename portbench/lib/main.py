"""A run from its arguments to its one result line.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics; each is read by its own reader,
``metrics/<name>.py`` (``read(run)``: a number, or None when it finds
nothing to read, and the metric is then left out).  The numbers the
check compared close the line (``checks``) and standard error.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time

from portbench.lib import spec as spec_mod
from portbench.lib.trace import top

#: Top-level modules the process must not hold once the window has closed.
BANNED = ("jax", "jaxlib", "flax", "repro")


def reader(name: str, bench_dir=spec_mod.HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read


def banned_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is banned, compared whole
    (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in BANNED})


def card(device) -> dict:
    """What the run line says of the device."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def measure(cell, seed: int, seconds: float, traced: bool, *, device="cuda",
            t0: float | None = None, bench_dir=spec_mod.HERE) -> dict:
    """One run; returns the result object (not yet printed)."""
    from portbench.lib.cell import Harness
    t0 = time.perf_counter() if t0 is None else t0
    h = Harness(cell, seed, device)
    h.setup()
    setup_s = time.perf_counter() - t0
    run = h.window(seconds, traced, setup_s)
    dev = card(h.device)
    dev["memory_peak_bytes"] = h.memory_peak()
    h.release()
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:
        value = reader(m["name"], bench_dir)(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    checks = h.check(run)
    check_s = time.perf_counter() - t_check
    del h
    n_req = sum(b.rows for b in run.batches)
    failed = sum(b.rows for b in run.batches
                 if b.served is None
                 or b.served.shape != (b.rows, run.traffic.decode_tokens))
    out = {"correct": failed == 0 and all(
               c["value"] <= c["limit"] for c in checks.values()),
           "attempted": n_req, "failed": failed, "metrics": metrics,
           "device": dev}
    out["info"] = {"batches": len(run.batches), "window_s": run.window_s,
                   "check_s": check_s, "card": power_limit()
                   if dev["platform"] == "gpu" else "cpu"}
    tl = run.timeline
    if traced and tl is not None:
        dev["busy_s"] = tl.busy_s
        dev["window_s"] = tl.window_s
        out["breakdown"] = {
            "device_ops": [[k[:200], v] for k, v in top(tl.by_op)],
            "idle_gaps": top(tl.idle_by_host)}
        out["info"]["busy_by_host"] = tl.busy_by_host
    out["checks"] = checks
    _log(bench_dir, cell.name, seed, traced, run, out)
    return out


def _log(bench_dir, name: str, seed: int, traced: bool, run, out) -> None:
    """Each batch's times and the result, a few kB in ``out/runs/``."""
    d = bench_dir / "out" / "runs"
    d.mkdir(parents=True, exist_ok=True)
    batches = [{k: getattr(b, k) for k in ("start", "first_token", "end",
                                           "lookup_s", "prefill_s",
                                           "submit_s", "decode_s",
                                           "restored")}
               for b in run.batches]
    (d / f"{name}-{seed}-t{int(traced)}.json").write_text(json.dumps(
        {"result": out, "counters": run.counters, "batches": batches}))


def emit(result: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
