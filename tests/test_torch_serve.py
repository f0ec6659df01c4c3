"""The whole slice end to end: ``run_request_loop`` + ``AdmitQueue`` +
``PrefixResumeEngine`` on reduced yi-9b in both packages over the same
zipf-ish request batches, and reduced falcon-mamba and zamba2 on the
resume-off path; plus the port's isolation from JAX and from the
reference package."""
from __future__ import annotations

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as j_configs
from repro.launch import serve as j_serve
from repro.models import transformer as j_tf
from repro.serve import admit_queue as j_aq
from repro.serve import kv_index as j_kv
from repro.serve import step as j_step
from repro_torch import configs as t_configs
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import transformer as t_tf
from repro_torch.serve import admit_queue as t_aq
from repro_torch.serve import kv_index as t_kv
from test_torch_kv_index import _assert_index_equal
from test_torch_model import _top2_gap, assert_greedy_agree

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_LAYERS, S, B, DECODE = 2, 48, 2, 3


def _requests(vocab: int, n_batches: int = 6, seed: int = 0):
    """Zipf-ish prompts: a few shared 32-token prefixes (rank-skewed) with
    random 16-token tails, so later batches hit earlier chunks."""
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(1, vocab, (3, 32)).astype(np.int32)
    p = 1.0 / np.arange(1, 4) ** 1.2
    out = []
    for _ in range(n_batches):
        pick = rng.choice(3, size=B, p=p / p.sum())
        tails = rng.integers(1, vocab, (B, S - 32)).astype(np.int32)
        out.append(np.concatenate([prefixes[pick], tails], axis=1))
    return out


def _j_decode_fn(engine, gaps):
    """The reference engine's greedy decode, also recording the top-1/
    top-2 logit gap of every emitted token (for the margin rule)."""
    def decode_fn(toks, result):
        st = result.state
        logits, cache, pos = st["logits"], st["cache"], st["pos"]
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        outs, g = [], []
        for t in range(DECODE):
            outs.append(np.asarray(nxt))
            g.append(_top2_gap(np.asarray(logits)))
            nxt, logits, cache = engine._decode(engine.params, cache, nxt,
                                                jnp.int32(pos + t))
        gaps.append(np.stack(g, 1))
        return np.concatenate(outs, axis=1)
    return decode_fn


def _j_plain_fns(jp, jcfg, max_seq: int, gaps: list):
    """The reference's non-resume pair (jitted prefill and greedy decode,
    as its ``build_model_fns(resume=False)``), its decode also recording
    the top-1/top-2 logit gap of every emitted token."""
    prefill = jax.jit(j_step.make_prefill_step(jcfg, max_seq))
    decode = jax.jit(j_step.make_decode_step(jcfg))

    def prefill_fn(toks, hits):
        return prefill(jp, {"tokens": jnp.asarray(toks)})

    def decode_fn(toks, state):
        logits, cache = state
        outs, g = [], []
        for t in range(DECODE):
            lg = np.asarray(logits)
            outs.append(lg.argmax(-1))
            g.append(_top2_gap(lg))
            nxt = jnp.asarray(outs[-1].astype(np.int32)[:, None])
            _, logits, cache = decode(jp, cache, nxt,
                                      jnp.int32(toks.shape[1] + t))
        gaps.append(np.stack(g, 1))
        return np.stack(outs, 1)

    return prefill_fn, decode_fn


#: yi-9b on the resume path; the recurrent models with resume off and a
#: "block" index (as both launchers serve them): hits counted, every
#: prefill full.
@pytest.mark.parametrize("arch,background", [
    ("yi-9b", False), ("yi-9b", True), ("falcon-mamba-7b", False),
    ("zamba2-2.7b", True)],
    ids=["False", "True", "falcon-mamba-7b-False", "zamba2-2.7b-True"])
def test_request_loop_matches_reference(arch, background):
    jcfg, tcfg = (c.get_arch(arch).reduced() for c in (j_configs, t_configs))
    if arch == "yi-9b":
        jcfg, tcfg = (dataclasses.replace(c, n_layers=N_LAYERS)
                      for c in (jcfg, tcfg))
    resume = t_tf.resume_supported(tcfg)
    jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    kv = dict(n_sets=8, fingerprint="prefix" if resume else "block",
              admit_after_reads=0)
    ji = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**kv),
                             slab_store=j_kv.KVSlabStore() if resume else None)
    ti = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**kv), device="cpu",
                             slab_store=t_kv.KVSlabStore() if resume else None)
    jq = j_aq.AdmitQueue(ji, background=background)
    tq = t_aq.AdmitQueue(ti, background=background)
    max_seq = S + DECODE
    gaps: list = []
    if resume:
        j_pf, _, j_eng = j_serve.build_model_fns(
            jp, jcfg, max_seq=max_seq, decode_tokens=DECODE, index=ji,
            resume=True)
        j_df = _j_decode_fn(j_eng, gaps)
    else:
        j_pf, j_df = _j_plain_fns(jp, jcfg, max_seq, gaps)
    t_pf, t_df, t_eng = t_serve.build_model_fns(
        tp, tcfg, max_seq=max_seq, decode_tokens=DECODE, index=ti,
        resume=resume)
    reqs = _requests(tcfg.vocab_size)
    launches = t_ops.LAUNCH_COUNT
    jrec = j_serve.run_request_loop(jq, reqs, prefill_fn=j_pf,
                                    decode_fn=j_df)
    trec = t_serve.run_request_loop(tq, reqs, prefill_fn=t_pf,
                                    decode_fn=t_df)
    jq.close()
    tq.close()
    assert t_ops.LAUNCH_COUNT - launches == ti.stats.searches == len(reqs)
    for i, (j, t) in enumerate(zip(jrec, trec)):
        assert (t.chunks, t.hit_chunks, t.resumed_chunks, t.admitted) == (
            j.chunks, j.hit_chunks, j.resumed_chunks, j.admitted), i
        assert t.decoded.shape == j.decoded.shape == (B, DECODE)
        assert_greedy_agree(t.decoded, j.decoded, gaps[i])
    assert sum(r.hit_chunks for r in trec) > 0
    if resume:
        assert sum(r.resumed_chunks for r in trec) > 0
        assert t_eng.resumed_chunks == j_eng.resumed_chunks
        assert ti.slab_store.resident_bytes == ji.slab_store.resident_bytes
        assert ti.slab_lockstep_report() == {"missing_slabs": [],
                                             "orphan_slabs": []}
    else:
        assert t_eng is None and ti.slab_store is None
        assert all(r.resumed_chunks == 0 for r in trec)
    if background:
        # the async worker may stamp t_MWW cycles at another point of
        # the op clock, so only the placement state is held exactly
        assert ti.slot_of == ji.slot_of
        np.testing.assert_array_equal(ti.bits.numpy(), np.asarray(ji.bits))
    else:
        _assert_index_equal(ji, ti)


def test_launcher_main_on_cpu(capsys):
    records = t_serve.main(["--arch", "yi-9b", "--reduced", "--device",
                            "cpu", "--requests", "6", "--decode-tokens",
                            "2", "--sync-admit"])
    assert len(records) == 3
    assert all(r.decoded.shape == (2, 2) for r in records)
    assert sum(r.resumed_chunks for r in records) > 0
    out = capsys.readouterr().out
    assert "index hit rate" in out and "on cpu" in out
    # --n-shards now serves: two set shards co-located on the one device
    records = t_serve.main(["--reduced", "--device", "cpu", "--n-shards",
                            "2", "--requests", "6", "--decode-tokens", "2",
                            "--sync-admit"])
    assert len(records) == 3 and sum(r.hit_chunks for r in records) > 0
    out = capsys.readouterr().out
    assert "sharded over 2 set shards (4 sets each; co-located" in out


# ---------------------------------------------------------------------------
# Isolation: the port needs neither JAX nor the reference package.
# ---------------------------------------------------------------------------

_BLOCKED = ("jax", "jaxlib", "repro")


PORT_EXAMPLES = ("train_lm_torch", "quickstart_torch", "kv_store_torch",
                 "string_search_torch", "serve_prefix_cache_torch")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "tests" / "_torch_mesh_ranks.py",
        ROOT / "tests" / "_torch_mesh_serve_ranks.py",
        ROOT / "tests" / "_torch_mesh_mp_ranks.py",
        ROOT / "tests" / "_torch_httpd_diverged.py"] + [
        ROOT / "examples" / f"{name}.py" for name in PORT_EXAMPLES]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _BLOCKED, (path, name)


_ISOLATED = f"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
sys.path.insert(0, "examples")
import train_lm_torch, quickstart_torch, kv_store_torch
import string_search_torch, serve_prefix_cache_torch
sys.path.insert(0, "tests")
import _torch_mesh_mp_ranks, _torch_mesh_ranks
assert not any(m.split(".")[0] in {_BLOCKED!r} for m in sys.modules)
assert {{"repro_torch.serve.http_frontend",
         "repro_torch.launch.httpd", "repro_torch.models.moe",
         "repro_torch.train.step", "repro_torch.train.optimizer",
         "repro_torch.launch.train", "repro_torch.dist.checkpoint",
         "repro_torch.dist.compression", "repro_torch.dist.elastic",
         "repro_torch.dist.straggler", "repro_torch.dist.sharding",
         "repro_torch.launch.mesh", "repro_torch.launch.specs",
         "repro_torch.launch.dryrun"}} <= set(mods)
print("imported", len(mods))
"""


def test_port_imports_with_jax_and_reference_refused():
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"))
    assert proc.returncode == 0, proc.stderr
    # importing ran nothing: the only output is the check's own line
    assert proc.stdout.strip().startswith("imported")
    assert int(proc.stdout.split()[1]) >= 20
