"""What the benchmark may load and open: no JAX, no JAX package, nothing
under ``benchmarks/``; and a cell, a traffic mix and a metric are each
found by name from a file of their own."""
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

from portbench.lib import main as bench
from portbench.lib.spec import HERE, ROOT, load_cell

GUARD = textwrap.dedent("""
    import builtins, importlib.abc, io, json, os, pathlib, sys
    BANNED = {"jax", "jaxlib", "flax", "repro"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    opened = []
    real_open = io.open

    def spy(file, *a, **k):
        opened.append(os.fspath(file) if not isinstance(file, int) else "")
        return real_open(file, *a, **k)

    builtins.open = io.open = spy
    sys.path[:0] = [sys.argv[1], sys.argv[2] + "/src", sys.argv[2]]
    import tiny
    from portbench.lib import main as bench, spec
    d = tiny.make(pathlib.Path(sys.argv[3]))
    for name in ("tiny.dense", "tiny.hybrid"):
        for traced in (False, True):
            r = bench.measure(spec.load_cell(name, d), 5, 0.3, traced,
                              device="cpu", bench_dir=d)
            assert r["correct"], r
    print(json.dumps({"modules": sorted(sys.modules), "opened": opened}))
""")


def test_nothing_banned_is_imported_or_opened(tmp_path):
    p = subprocess.run(
        [sys.executable, "-c", GUARD, str(HERE / "tests"), str(ROOT),
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    seen = json.loads(p.stdout.strip().splitlines()[-1])
    assert bench.banned_modules(seen["modules"]) == []
    assert "repro_torch" in {m.split(".")[0] for m in seen["modules"]}
    refs = ROOT / "benchmarks"
    for f in seen["opened"]:
        if f:
            assert refs not in pathlib.Path(f).resolve().parents, f


def test_banned_names_compare_whole():
    assert bench.banned_modules(["repro_torch.models", "jaxtyping",
                                 "numpy"]) == []
    assert bench.banned_modules(["repro.serve", "jax.numpy", "flax",
                                 "jaxlib"]) == ["flax", "jax.numpy",
                                                "jaxlib", "repro.serve"]


def test_sources_import_nothing_banned():
    for f in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in bench.BANNED, (f, n)


def test_reference_imports_nothing_of_the_program():
    for f in (HERE / "reference").glob("*.py"):
        src = f.read_text()
        assert "repro_torch" not in src, f


def test_a_new_cell_is_new_files(tiny_dir, tmp_path):
    """A configuration, a traffic mix, a metric reader and a limits file
    dropped beside the others, and entries added to ``BENCHMARK.json``:
    the harness finds them by name, no existing file edited."""
    import shutil
    d = tmp_path / "portbench"
    shutil.copytree(tiny_dir, d)
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    bench_json = json.loads((tiny_dir.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((d / "configs" / "tiny-yi-9b.json").read_text())
    cfg.update(name="tiny-yi-9b-wide")
    cfg["model"]["d_ff"] = 192
    (d / "configs" / "tiny-yi-9b-wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((d / "traffic" / "tiny_prefix.json").read_text())
    traffic.update(name="tiny_unique", doc_share=0, doc_pool=0,
                   fill_touches=0)
    (d / "traffic" / "tiny_unique.json").write_text(json.dumps(traffic))
    (d / "cells" / "tiny.new.json").write_text(json.dumps(
        {"limits": {"hit_mismatch": 0, "max_gap": 0.12}}))
    (d / "metrics" / "batches_served.py").write_text(
        '"""Batches the window served."""\n\n\n'
        "def read(run):\n    return float(len(run.batches))\n")
    bench_json["configs"].append(
        {"name": cfg["name"], "source": cfg["source"],
         "file": "portbench/configs/tiny-yi-9b-wide.json",
         "reduced": cfg["reduced"], "why": "test"})
    bench_json["workloads"].append(
        {"name": "tiny.new", "config": cfg["name"], "traffic": "tiny_unique",
         "chips": 1, "why": "test"})
    bench_json["per_layer"].append(
        {"name": "batches_served", "unit": "batches", "better": "higher",
         "source": "host_clock", "layer": "request loop",
         "moves": "out_tokens_per_s", "workloads": ["tiny.new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    cell = load_cell("tiny.new", d)
    assert cell.config["model"]["d_ff"] == 192
    r = bench.measure(cell, 9, 0.3, True, device="cpu", bench_dir=d)
    assert r["correct"], r["checks"]
    assert r["metrics"]["batches_served"]["value"] >= 1
    assert "resumed_chunk_pct" not in r["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data
