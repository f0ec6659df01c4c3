"""``BENCHMARK.json`` and a run's last line against the benchmark's
contract."""
import json
import re
import subprocess
import sys

import pytest

from portbench.lib import main as bench
from portbench.lib.spec import HERE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head|expand|top_k|d_model|d_ff")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["source"].startswith("https://") and _line(c["source"])
        assert c["file"].startswith("portbench/") and _line(c["why"])
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "cells" / f"{w['name']}.json").exists()


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in e2e}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    # every cell: setup_s, another end-to-end metric, a per-layer metric
    for c in cells:
        cell = load_cell(c)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        moved = {m["moves"] for m in cell.per_layer}
        assert moved <= {m["name"] for m in cell.end_to_end}
    # a kernel's roofline has the whole step's share beside it, moving
    # the same end-to-end metric
    for m in layer:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in n["name"] and n["moves"] == m["moves"]
                       for n in layer)


def test_run_line(tiny_dir, capsys):
    """The last line of a (CPU) run: the keys a reader of it needs, each
    metric with its value and unit, the numbers compared last."""
    cell = load_cell("tiny.dense", tiny_dir)
    for traced in (False, True):
        bench.emit(bench.measure(cell, 2 ** 31 + 11, 0.5, traced,
                                 device="cpu", bench_dir=tiny_dir))
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] > 0
        want = cell.per_layer if traced else cell.end_to_end
        for m in want:
            if m["name"] in line["metrics"]:
                assert line["metrics"][m["name"]]["unit"] == m["unit"]
        if not traced:
            assert set(line["metrics"]) == {m["name"] for m in want}
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        tail = err.strip().splitlines()[-2:]
        assert [t.split()[1] for t in tail] == ["hit_mismatch", "max_gap"]
        assert all(" limit " in t for t in tail)


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints
    nothing on standard output; so does a checkout holding only
    ``BENCHMARK.json`` and the benchmark's folder."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for root in (ROOT, tmp_path):
        if root == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(HERE, tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("out", "__pycache__"))
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "yi9b.shared_prefix", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=root, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0 and p.stdout == ""
