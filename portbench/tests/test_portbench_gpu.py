"""On the card: every cell of ``BENCHMARK.json`` runs a short window with
the benchmark's own command and comes out correct, with the last line's
keys.  Skips without a card (decided in the fixture)."""
import json
import subprocess
import sys

import pytest

from portbench.lib.spec import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
