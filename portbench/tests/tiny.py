"""A benchmark folder with two tiny cells, for the CPU tests: the real
metric readers, and configuration, traffic and limit files cut to sizes
the CPU serves in a second."""
from __future__ import annotations

import copy
import json
import pathlib
import shutil

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent

TINY_MODEL = {
    "yi-9b": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
              "d_head": 16, "d_ff": 128, "vocab_size": 512},
    "zamba2-2.7b": {"n_layers": 6, "d_model": 64, "n_heads": 4,
                    "n_kv_heads": 4, "d_head": 32, "d_ff": 128,
                    "vocab_size": 512, "ssm_state": 16,
                    "ssm_head_dim": 16, "shared_attn_every": 3},
}
TINY_TRAFFIC = {"batch": 4,
                "prompt_tokens": {"median": 96, "sigma": 0.5, "levels": 3},
                "out_tokens": {"median": 6, "sigma": 0.5}, "doc_pool": 6,
                "sample_requests": 8}
#: The tiny cells' widest served-token gap.  CPU readings, seeds 1-14:
#: the bf16 program 0.0293 at most (dense; hybrid 0.0365), the fp8
#: control 0.182 at least (hybrid; dense 0.198).
TINY_GAP = 0.12


def make(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp/BENCHMARK.json`` and ``tmp/portbench/`` holding the tiny
    cells ``tiny.dense`` and ``tiny.hybrid``; returns the folder."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = tmp / "portbench"
    for sub in ("configs", "traffic", "cells"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", out / "metrics")
    traffic = json.loads((HERE / "traffic" / "shared_prefix.json").read_text())
    traffic.update(TINY_TRAFFIC, name="tiny_prefix")
    (out / "traffic" / "tiny_prefix.json").write_text(json.dumps(traffic))
    configs, cells = [], []
    for cell, name in (("tiny.dense", "yi-9b"), ("tiny.hybrid", "zamba2-2.7b")):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg = copy.deepcopy(cfg)
        cfg["model"].update(TINY_MODEL[name])
        cfg["name"] = f"tiny-{name}"
        cfg["reduced"] = sorted(TINY_MODEL[name])
        cfg["index"]["set_ways"] = 64
        (out / "configs" / f"tiny-{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": cfg["name"], "source": cfg["source"],
                        "file": f"portbench/configs/tiny-{name}.json",
                        "reduced": cfg["reduced"], "why": "CPU test"})
        cells.append({"name": cell, "config": cfg["name"],
                      "traffic": "tiny_prefix", "chips": 1,
                      "why": "CPU test"})
        (out / "cells" / f"{cell}.json").write_text(json.dumps(
            {"limits": {"hit_mismatch": 0, "max_gap": TINY_GAP}}))
    names = [c["name"] for c in cells]
    bench.update(configs=configs, workloads=cells)
    for m in bench["per_layer"]:
        m["workloads"] = names
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return out
