"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; each of those is a file of its own
(``configs/<config>.json``, ``traffic/<traffic>.json``), each cell's
correctness limits are ``cells/<cell>.json``, and each metric is read by
``metrics/<metric>.py``.  Adding a cell or a metric is adding files: no
code here names one.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

#: The benchmark's own folder; the checkout's root is its parent.
HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with everything it names, read."""
    name: str
    chips: int
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # cells/<cell>.json "limits"
    end_to_end: list       # the metric entries this cell reports
    per_layer: list
    bench_dir: pathlib.Path


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: pathlib.Path = HERE,
              benchmark: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``benchmark`` (default: ``BENCHMARK.json``
    beside ``bench_dir``), its files read from ``bench_dir``."""
    bench = _load(benchmark or bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load(bench_dir.parent / cfg_entry["file"])
    if config.get("name") != cfg_entry["name"]:
        raise ValueError(f"{cfg_entry['file']} names {config.get('name')!r},"
                         f" not {cfg_entry['name']!r}")
    traffic = _load(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _load(bench_dir / "cells" / f"{name}.json")["limits"]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def arch_config(config: dict):
    """The program's ``ArchConfig`` for a configuration file: the
    registered architecture ``config["arch"]`` with every size of
    ``config["model"]`` set as the file states it."""
    from repro_torch import configs
    base = configs.get_arch(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    unknown = sorted(set(config["model"]) - fields)
    if unknown:
        raise ValueError(f"{config['name']}: unknown model keys {unknown}")
    return dataclasses.replace(base, **config["model"])
