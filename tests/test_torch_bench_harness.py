"""The port's bench harness and emission (``repro_torch/bench``).

Mirrors ``tests/test_bench_harness.py``: ``_block`` exists to close out
CUDA's asynchronous launches before a timing sample is taken, and must
let every failure of that synchronisation propagate, so a poisoned
computation cannot time as a clean pass.  A tensor that reports a card
(``_OnCard``) and a patched ``torch.cuda.synchronize`` stand in for the
reference's fake ``block_until_ready``.  Then ``BenchSizes`` against the
reference's, and the envelope ``emit_json`` writes for a CPU run.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro.bench.harness import BenchSizes as RefBenchSizes
from repro_torch.bench import emit, harness
from repro_torch.bench.harness import BenchSizes, _block, time_callable
from repro_torch.kernels import autotune


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card, so ``_block`` synchronises it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def sync(monkeypatch):
    """``torch.cuda.synchronize`` recorded, raising ``sync.exc`` if set."""
    class Sync:
        exc = None
        calls: list = []

        def __call__(self, dev=None):
            self.calls.append(dev)
            if self.exc is not None:
                raise self.exc("surfaced at sync")
    s = Sync()
    s.calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", s)
    return s


def _on_card():
    return torch.ones(4).as_subclass(_OnCard)


def test_block_passes_tensor_and_host_results(sync):
    _block(torch.ones(4))          # a CPU tensor needs no sync
    _block(None)                   # plain host objects are fine
    _block({"a": [1, 2.0, "s"]})
    assert sync.calls == []
    _block({"a": [torch.ones(2), (_on_card(), 3)], "b": _on_card()})
    assert sync.calls == [torch.device("cuda", 0)]   # once per device


def test_block_needs_nothing_of_host_objects(sync):
    """The reference swallows the complaints of pytree flattening over
    host objects; the port never asks a host object anything."""
    sync.exc = RuntimeError
    _block(object())
    _block([TypeError, ValueError, {"x": "y"}])
    assert sync.calls == []


@pytest.mark.parametrize("exc", [RuntimeError, OSError])
def test_block_propagates_runtime_failures(sync, exc):
    sync.exc = exc
    with pytest.raises(exc, match="surfaced at sync"):
        _block(_on_card())


def test_time_callable_does_not_time_a_poisoned_computation(sync):
    """A callable whose result fails at sync must fail the bench, not
    produce a Timing."""
    sync.exc = RuntimeError
    with pytest.raises(RuntimeError, match="surfaced at sync"):
        time_callable(_on_card, warmup=1, reps=2)
    t = time_callable(lambda: torch.ones(8) * 2, warmup=1, reps=2)
    assert t.median_us > 0 and t.reps == 2
    ts = harness.time_interleaved([lambda: torch.ones(2), lambda: None],
                                  reps=3)
    assert [x.reps for x in ts] == [3, 3]


@pytest.mark.parametrize("quick", [False, True])
def test_bench_sizes_match_reference(quick):
    got, want = BenchSizes(quick), RefBenchSizes(quick)
    for f in ("fig_requests", "kernel_reps", "systems"):
        assert getattr(got, f) == getattr(want, f), f
    assert [f.name for f in dataclasses.fields(got)] == ["quick"]


def test_emit_json_envelope_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_OUT_DIR", str(tmp_path))
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "absent.json"))
    monkeypatch.delenv("REPRO_MACHINE", raising=False)
    monkeypatch.delenv("REPRO_PLANE_FORMAT", raising=False)
    autotune.reset_cache()
    path = emit.emit_json("torch_probe", {"t": torch.tensor([1.5, 2.0]),
                                          "n": torch.tensor(3)},
                          quick=True, device="cpu")
    assert path == str(tmp_path / "BENCH_torch_probe.json")
    doc = json.loads(open(path).read())
    assert doc == {"bench": "torch_probe",
                   "created_unix": doc["created_unix"], "device": "cpu",
                   "n_devices": 1, "plane_format": "int8",
                   "autotune_cache": "cold", "machine": "cpu-interpret",
                   "quick": True, "t": [1.5, 2.0], "n": 3}
    # the default device is the card: no card, no artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        emit.emit_json("torch_probe", {})
    autotune.reset_cache()


def test_bench_out_dir_defaults_to_build(monkeypatch):
    monkeypatch.delenv("BENCH_OUT_DIR", raising=False)
    out = emit.bench_out_dir()
    assert out.endswith("build/bench") and "benchmarks" not in out
