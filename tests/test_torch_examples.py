"""The port's four examples run end to end on the CPU (``--device cpu``),
as ``tests/test_examples_and_opts.py`` runs the reference's, and print the
reference's deterministic lines; without a card their default device
raises."""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
EXAMPLES = ("quickstart_torch", "kv_store_torch", "string_search_torch",
            "serve_prefix_cache_torch")


def _run_example(name, *args, timeout=300):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args,
         "--device", "cpu"],
        env=ENV, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_quickstart_example():
    out = _run_example("quickstart_torch.py")
    assert "search found column 137 (1 match)" in out
    assert "query 3 matches columns [42]" in out
    assert "kv_lookup(0xBEEF) -> 202" in out
    assert "kv_lookup(0xDEAD) -> None" in out
    assert "masked lookup (key=0xF000, mask=0xFF00) -> 303" in out
    assert ("command log: ['W mask_reg', 'W key/mask -> superset 0', "
            "'S set=0', 'R ram 2']") in out


def test_string_search_example():
    out = _run_example("string_search_torch.py", "--mib", "0.25")
    assert "matches: " in out and "fewer memory commands" in out
    assert "(plain version on the CPU)" in out
    assert "matches: 1 in " in out and "64x fewer memory commands" in out


def test_kv_store_example():
    out = _run_example("kv_store_torch.py")
    assert "lookup" in out and "searches=" in out
    assert "lookup(0x673269a56221) = 170 (expect 170)" in out
    assert "3789 lookups (100.0% hit), 211 inserts" in out
    assert ("searches=3789 (Monarch) vs probes the baseline would issue "
            "serially; writes=1215, swaps=0, rehashes=0") in out


def test_serve_prefix_cache_example():
    """The reference's index lines, letter for letter: they depend on the
    prompts and the index, not on the weights (the example itself asserts
    the index/slab-store lockstep audit)."""
    out = _run_example("serve_prefix_cache_torch.py", "--requests", "5",
                       "--decode-tokens", "2")
    assert "chunk hit rate 13.3% (4/30); 5 CAM searches" in out
    assert "prefix KV resumed: 64/480" in out
    assert ("4 admissions, 22 no-allocate skips, 0 t_MWW throttles, "
            "0 evictions, 0 rotations") in out
    assert "install distribution over sets: [0, 1, 0, 0, 2, 0, 0, 1]" in out
    resumed = int(out.split("prefix KV resumed: ")[1].split("/")[0])
    assert resumed > 0, out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda, which raises without a card: no
    example drops to the CPU on its own."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
