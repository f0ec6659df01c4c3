"""End to end on the CPU at a tiny size, through the same harness and
references: sound runs come out correct; the control and each fault a
serving cell can have come out not correct."""
import numpy as np
import pytest
import torch

import tiny
from portbench.lib import main as bench
from portbench.lib.cell import Harness
from portbench.lib.spec import arch_config, load_cell
from portbench.reference import mamba2_hybrid

CELLS = ("tiny.dense", "tiny.hybrid")


def _measure(tiny_dir, name, seed=7, traced=False):
    return bench.measure(load_cell(name, tiny_dir), seed, 0.4, traced,
                         device="cpu", bench_dir=tiny_dir)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(tiny_dir, name):
    for seed, traced in ((3, False), (2 ** 35 + 1, True)):
        r = _measure(tiny_dir, name, seed, traced)
        assert r["correct"], r["checks"]
        assert r["checks"]["hit_mismatch"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_dir, name):
    """The float32 reference at fp8 in the program's place reads a gap
    over the limit on every seed tried."""
    cell = load_cell(name, tiny_dir)
    for seed in (1, 2, 3):
        h = Harness(cell, seed, "cpu")
        h.setup()
        run = h.window(0.3, False, 0.0)
        h.release()
        program, control = h.gaps(run, control=True)
        assert program <= tiny.TINY_GAP < control


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the cache as it
    was and the prompt's logits again."""
    from repro_torch.models import transformer
    real = transformer.prefill
    last = {}

    def prefill(*a, **k):
        out = real(*a, **k)
        last["logits"] = out[0]
        return out

    monkeypatch.setattr(transformer, "prefill", prefill)
    monkeypatch.setattr(transformer, "decode_step",
                        lambda params, cfg, tokens, cache, pos:
                        (last["logits"], cache))


def _half_batch(monkeypatch):
    """Half the batch left out: the second half's logits are the mean of
    the first half's."""
    from repro_torch.models import transformer
    real = transformer.prefill

    def prefill(*a, **k):
        out = real(*a, **k)
        logits = out[0]
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(0)
        return out

    monkeypatch.setattr(transformer, "prefill", prefill)


def _token_altered(monkeypatch):
    """One served token altered where it is produced (the greedy step)."""
    from repro_torch.serve import resume, step
    real = step.greedy

    def greedy(logits):
        t = real(logits).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t

    monkeypatch.setattr(step, "greedy", greedy)
    monkeypatch.setattr(resume, "greedy", greedy)


def _answer_altered(monkeypatch):
    """One lookup answer altered where it is produced (the index)."""
    from repro_torch.serve.kv_index import MonarchKVIndex
    real = MonarchKVIndex.lookup

    def lookup(self, tokens):
        hits = real(self, tokens).copy()
        hits[-1, -1] = ~hits[-1, -1]
        return hits

    monkeypatch.setattr(MonarchKVIndex, "lookup", lookup)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_not_correct(tiny_dir, monkeypatch, name, fault):
    """Each fault planted under the timed path (the exchange between
    chips is not among them: every cell runs on one chip)."""
    FAULTS[fault](monkeypatch)
    r = _measure(tiny_dir, name, seed=5)
    assert not r["correct"], r["checks"]


def test_scan_equals_its_recurrence():
    g = torch.Generator().manual_seed(0)
    r, s, h, p, n = 2, 150, 3, 4, 5
    x = torch.randn(r, s, h, p, generator=g)
    dt = torch.rand(r, s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 4
    b, c = torch.randn(r, s, n, generator=g), torch.randn(r, s, n,
                                                          generator=g)
    torch.testing.assert_close(mamba2_hybrid.scan(x, dt, a, b, c, chunk=32),
                               mamba2_hybrid.scan_recurrent(x, dt, a, b, c),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_reference_tracks_the_program_logits(tiny_dir, name):
    """The plain float32 reference and the program's bf16 prefill give
    the same last-position logits to bf16's accuracy."""
    import importlib
    from repro_torch.models import transformer
    from portbench.lib import weights
    cell = load_cell(name, tiny_dir)
    cfg = arch_config(cell.config)
    w = weights.make(cfg, 123, torch.device("cpu"))
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 80))
    prog, _ = transformer.prefill(w, cfg, {"tokens": toks}, 96)
    ref = importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")
    want = ref.logits(w, cell.config, torch.as_tensor(toks), 79)[:, 0]
    err = (prog - want).abs().max() / want.std()
    assert err < 0.05
