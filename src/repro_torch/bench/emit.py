"""Machine-readable benchmark artifacts: ``BENCH_<name>.json`` (port of
``repro/bench/emit.py``).

The envelope carries enough metadata to interpret a number months later:
the device the bench ran on and, on a card, its name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load); whether it was a quick or full sweep; when; and the
knobs that steer kernel speed without changing results: the resolved
plane format, the autotune cache fingerprint and the machine profile the
rooflines are drawn against.  Cross-run comparisons that mix envelopes
with different values for those fields are comparing different
configurations.

Artifacts go to ``$BENCH_OUT_DIR``, else ``build/bench/`` of the checkout
— never ``benchmarks/``, where the reference's artifacts of the same
names live.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import time

import torch

from repro_torch.device import resolve_device


def bench_out_dir() -> str:
    """Artifact directory: ``$BENCH_OUT_DIR``, else ``build/bench/`` of the
    checkout (of the working directory outside one); created if absent."""
    env = os.environ.get("BENCH_OUT_DIR")
    if env:
        os.makedirs(env, exist_ok=True)
        return env
    root = pathlib.Path(__file__).resolve().parents[3]
    if not (root / "src" / "repro_torch").is_dir():
        root = pathlib.Path.cwd()
    out = root / "build" / "bench"
    out.mkdir(parents=True, exist_ok=True)
    return str(out)


def card_identity(dev: torch.device) -> dict:
    """The card's name and power limit (W) from ``nvidia-smi``."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"device_name": name,
            "power_limit_w": float(limit.split()[0])}


def emit_json(name: str, payload: dict, *, quick: bool | None = None,
              device: str | torch.device = "cuda") -> str:
    """Write ``BENCH_<name>.json`` for a bench that ran on ``device`` and
    return its path.  ``device`` defaults to the card and raises without
    one; a CPU run passes ``device="cpu"`` and says so."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.common import resolve_plane_format
    from repro_torch.roofline.analysis import current_machine

    dev = resolve_device(device)
    doc = {
        "bench": name,
        "created_unix": round(time.time(), 3),
        "device": dev.type,
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "plane_format": resolve_plane_format(),
        "autotune_cache": autotune.cache_fingerprint(),
        "machine": current_machine().name,
    }
    if dev.type == "cuda":
        doc.update(card_identity(dev))
    if quick is not None:
        doc["quick"] = bool(quick)
    doc.update(payload)
    path = os.path.join(bench_out_dir(), f"BENCH_{name}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False, default=_coerce)
        f.write("\n")
    return path


def _coerce(obj):
    """JSON fallback for tensors and numpy scalars and arrays."""
    if torch.is_tensor(obj):
        return obj.tolist()
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except (TypeError, ValueError):   # .item() of an array
                pass
    return str(obj)
