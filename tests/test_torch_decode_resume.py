"""Prefix-cache decode resume on gemma3's local/global stack: the port
against the JAX reference (tests/test_decode_resume.py's cells), with the
reference's weights carried across.

* ``transformer.prefill(prefix_kv=...)``: logits, every decode-cache leaf
  (ring slots included: the prompts outrun the 32-token window) and the
  suffix KV against the reference's resumed prefill, and against the
  port's own full prefill, at (S, P) in {(48, 16), (48, 32), (40, 16)};
  then 3 greedy tokens from the resumed cache against the reference's.
  Cells: 4 local layers (remainder blocks only), 6 layers (one
  [local x 5, global] group) and 8 layers (the group plus two local
  remainder blocks).  Held to ``rtol=1e-2,
  atol=5e-2`` and the greedy margin rule, not to bit-identity: the
  reference's own resume is not bit-identical in its mixed cell
  (ROADMAP.md, Queue 3 item 1).
* Ring decode past the window against a plain-cache decode of the same
  tokens and, under the greedy margin rule, against a fresh full prefill
  over prompt + decoded tokens (the windowed prefill is an oracle
  independent of the ring).
* :class:`PrefixResumeEngine` through the index and slab store on the
  mixed config: hits resume, rotation keeps hits, eviction recomputes, a
  hit without its slab truncates the run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.models import transformer as t_tf
from repro_torch.pytree import tree_map
from repro_torch.serve.admit_queue import AdmitQueue
from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                        KVSlabStore, MonarchKVIndex)
from repro_torch.serve.resume import PrefixResumeEngine
from _torch_parity import plain_cache_decode
from test_torch_model import (_close, _top2_gap, _tree_close,
                              assert_greedy_agree, gemma_models)

CASES = ((48, 1), (48, 2), (40, 1))     # (S, prefix chunks)
N_DEC = 3
MAX_SEQ = 52                            # one cache shape for every case


@pytest.fixture(scope="module", params=["local", "mixed", "mixed8"])
def cell(request):
    return (request.param,) + gemma_models(request.param)


def _cell_prompts(vocab: int) -> list:
    """The prompts of tests/test_decode_resume.py's cells: one (2, S)
    draw per case, in case order, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, (2, s)).astype(np.int32)
            for s, _ in CASES]


def _j_greedy(jp, jcfg, logits, cache, pos):
    """The reference's greedy tokens and their top-1/top-2 gaps."""
    toks, gaps = [], []
    for t in range(N_DEC):
        lg = np.asarray(logits)
        toks.append(lg.argmax(-1))
        gaps.append(_top2_gap(lg))
        nxt = jnp.asarray(toks[-1].astype(np.int32)[:, None])
        logits, cache = j_tf.decode_step(jp, jcfg, nxt, cache,
                                         jnp.int32(pos + t))
    return np.stack(toks, 1), np.stack(gaps, 1)


def _t_greedy(tp, tcfg, logits, cache, pos):
    toks = []
    for t in range(N_DEC):
        toks.append(logits.argmax(-1).numpy())
        nxt = toks[-1][:, None]
        logits, cache = t_tf.decode_step(tp, tcfg, nxt, cache, pos + t)
    return np.stack(toks, 1)


@pytest.mark.parametrize("s,p_chunks", CASES)
def test_resumed_prefill_matches_reference(cell, s, p_chunks):
    tag, jcfg, tcfg, jp, tp = cell
    tag = f"{tag} S={s} P={p_chunks * CHUNK_TOKENS}"
    max_seq = MAX_SEQ
    toks = _cell_prompts(tcfg.vocab_size)[CASES.index((s, p_chunks))]
    p = p_chunks * CHUNK_TOKENS
    _, _, jkv = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             max_seq, return_kv=True)
    tl_f, tc_f, tkv = t_tf.prefill(tp, tcfg, {"tokens": toks}, max_seq,
                                   return_kv=True)
    jpre = jax.tree.map(lambda a: a[..., :p, :, :], jkv)
    tpre = tree_map(lambda a: a[..., :p, :, :], tkv)
    jl, jc, jsuf = j_tf.prefill(jp, jcfg,
                                {"tokens": jnp.asarray(toks[:, p:])},
                                max_seq, prefix_kv=jpre, return_kv=True)
    tl, tc, tsuf = t_tf.prefill(tp, tcfg, {"tokens": toks[:, p:]}, max_seq,
                                prefix_kv=tpre, return_kv=True)
    _close(tl, jl, f"{tag}: resumed logits vs reference")
    _tree_close(tc, jc, f"{tag}: resumed cache vs reference")
    _tree_close(tsuf, jsuf, f"{tag}: resumed kv vs reference")
    _close(tl, tl_f, f"{tag}: resumed vs full logits")
    _tree_close(tc, tc_f, f"{tag}: resumed vs full cache")
    want, gaps = _j_greedy(jp, jcfg, jl, jc, s)
    assert_greedy_agree(_t_greedy(tp, tcfg, tl, tc, s), want, gaps)


def test_ring_decode_past_the_window_matches_oracles():
    """8 decode steps from position 40 (window 32: the ring wrapped in
    prefill and keeps wrapping).  Each step's logits against a plain-cache
    decode of the same tokens with the local layers masked to the window
    (the ring's only difference is the slot order); the greedy tokens
    against a fresh full prefill over prompt + decoded tokens under the
    margin rule; and the first layer's ring (keys that depend on no
    earlier layer) slot for slot against that prefill's ring.  Decode and
    full prefill round bf16 differently (softmax before or after the value
    product, other GEMM shapes), so their logits are not held to the
    tolerance at this width."""
    _, tcfg, _, tp = gemma_models("mixed8")
    s, n = 40, 8
    prompt = np.random.default_rng(9).integers(1, tcfg.vocab_size,
                                               (2, s)).astype(np.int32)
    want, fed = plain_cache_decode(tp, tcfg, prompt, n)
    logits, cache = t_tf.prefill(tp, tcfg, {"tokens": prompt}, s + n)
    for t in range(n):
        logits, cache = t_tf.decode_step(tp, tcfg, fed[:, t:t + 1], cache,
                                         s + t)
        _close(logits, want[t], f"ring vs plain cache, step {t}")
        seq = np.concatenate([prompt, fed[:, :t + 1].numpy()], axis=1)
        full, fcache = t_tf.prefill(tp, tcfg, {"tokens": seq}, s + n)
        assert_greedy_agree(logits.argmax(-1).numpy()[:, None],
                            full.argmax(-1).numpy()[:, None],
                            _top2_gap(full.numpy())[:, None])
    ring = cache["groups"]["b0"]
    assert ring["k"].shape[2] == tcfg.sliding_window
    _tree_close(ring, fcache["groups"]["b0"], "first layer's ring")


def test_unsupported_and_misconfigured_engines_raise():
    ssm = t_configs.get_arch("falcon-mamba-7b").reduced()
    assert not t_tf.resume_supported(ssm)
    idx = MonarchKVIndex(KVIndexConfig(fingerprint="prefix"),
                         slab_store=KVSlabStore(), device="cpu")
    with pytest.raises(NotImplementedError):
        PrefixResumeEngine({}, ssm, max_seq=40, index=idx, device="cpu")
    _, tcfg, _, tp = gemma_models("mixed")
    with pytest.raises(ValueError, match="fingerprint"):
        PrefixResumeEngine(tp, tcfg, max_seq=64, device="cpu",
                           index=MonarchKVIndex(KVIndexConfig(),
                                                slab_store=KVSlabStore(),
                                                device="cpu"))
    with pytest.raises(ValueError, match="KVSlabStore"):
        PrefixResumeEngine(tp, tcfg, max_seq=64, device="cpu",
                           index=MonarchKVIndex(
                               KVIndexConfig(fingerprint="prefix"),
                               device="cpu"))


# ---------------------------------------------------------------------------
# Engine + index + slab store (mixed gemma3).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    _, tcfg, _, tp = gemma_models("mixed")
    return tcfg, tp


def _mk_index(**kw):
    base = dict(n_sets=8, set_ways=8, admit_after_reads=0,
                rotate_every=1 << 30, fingerprint="prefix")
    base.update(kw)
    return MonarchKVIndex(KVIndexConfig(**base), slab_store=KVSlabStore(),
                          device="cpu")


def _mk_engine(idx, mixed):
    tcfg, tp = mixed
    return PrefixResumeEngine(tp, tcfg, max_seq=80, index=idx,
                              decode_tokens=4, device="cpu")


def _reference(engine, toks):
    """Full-prefill greedy tokens and their top-1/top-2 gaps, from a
    prefill that bypasses the index."""
    logits, cache = t_tf.prefill(engine.params, engine.cfg,
                                 {"tokens": toks}, engine.max_seq)
    out, gaps = [], []
    for t in range(engine.decode_tokens):
        out.append(logits.argmax(-1).numpy())
        gaps.append(_top2_gap(logits.numpy()))
        nxt = out[-1][:, None]
        logits, cache = t_tf.decode_step(engine.params, engine.cfg, nxt,
                                         cache, toks.shape[1] + t)
    return np.stack(out, 1), np.stack(gaps, 1)


def _serve_once(engine, q, toks):
    hits = q.lookup(toks)
    res = engine.prefill(toks, hits)
    q.submit_tokens(toks, slabs=res.slabs)
    return res, engine.decode(res)


@pytest.mark.parametrize("kind", ["mixed", "mixed8"])
def test_engine_hit_resumes_and_decodes_identically(rng, kind):
    """Second serving of a prompt resumes all but its last chunk from
    slabs (8 layers: slabs carry the remainder blocks' leaves too)."""
    _, tcfg, _, tp = gemma_models(kind)
    idx = _mk_index()
    engine = _mk_engine(idx, (tcfg, tp))
    q = AdmitQueue(idx)
    try:
        for s, run in ((64, 3), (72, 4)):    # 72: 8 leftover tokens
            toks = rng.integers(1, 512, (1, s)).astype(np.int32)
            want, gaps = _reference(engine, toks)
            res1, dec1 = _serve_once(engine, q, toks)
            assert res1.resumed_chunks == 0
            res2, dec2 = _serve_once(engine, q, toks)
            assert res2.resumed_chunks == run
            assert res2.computed_chunks == s // CHUNK_TOKENS - run
            assert_greedy_agree(dec1, want, gaps)
            assert_greedy_agree(dec2, want, gaps)
        audit = idx.slab_lockstep_report()
        assert not audit["missing_slabs"] and not audit["orphan_slabs"]
    finally:
        q.close()


def test_engine_hit_survives_rotation(rng, mixed):
    idx = _mk_index()
    engine = _mk_engine(idx, mixed)
    q = AdmitQueue(idx)
    try:
        toks = rng.integers(1, 512, (1, 64)).astype(np.int32)
        want, gaps = _reference(engine, toks)
        _serve_once(engine, q, toks)
        q.rotate()
        assert idx.stats.rotations == 1
        res, dec = _serve_once(engine, q, toks)
        assert res.resumed_chunks == 3
        assert_greedy_agree(dec, want, gaps)
        audit = idx.slab_lockstep_report()
        assert not audit["missing_slabs"] and not audit["orphan_slabs"]
    finally:
        q.close()


def test_engine_eviction_drops_slab_and_recomputes(rng, mixed):
    idx = _mk_index(n_sets=4, set_ways=4)
    engine = _mk_engine(idx, mixed)
    q = AdmitQueue(idx)
    try:
        toks = rng.integers(1, 512, (1, 64)).astype(np.int32)
        want, gaps = _reference(engine, toks)
        _serve_once(engine, q, toks)
        fps0 = {int(f) for f in idx.fingerprints(toks).reshape(-1)}
        flood = rng.integers(1 << 20, 1 << 30, 4096).astype(np.uint32)
        q.submit(np.unique(flood))
        q.flush()
        assert idx.stats.evictions > 0
        evicted = fps0 - set(idx.slot_of)
        assert evicted, "flood failed to evict the prefix"
        assert all(idx.slab_store.get(f) is None for f in evicted)
        res, dec = _serve_once(engine, q, toks)
        assert res.resumed_chunks < 3
        assert_greedy_agree(dec, want, gaps)
        assert not idx.slab_lockstep_report()["orphan_slabs"]
    finally:
        q.close()


def test_engine_truncates_run_at_missing_slab(rng, mixed):
    idx = _mk_index()
    engine = _mk_engine(idx, mixed)
    q = AdmitQueue(idx)
    try:
        toks = rng.integers(1, 512, (1, 64)).astype(np.int32)
        q.submit_tokens(toks)               # admitted WITHOUT slabs
        q.flush()
        assert q.lookup(toks).all()
        res, _ = _serve_once(engine, q, toks)
        assert res.resumed_chunks == 0 and res.computed_chunks == 4
        res2, _ = _serve_once(engine, q, toks)
        assert res2.resumed_chunks == 3
        # a slab is one chunk of every layer: group leaves (G, 1, 16, KV,
        # dh), none of the remainder's
        slab = idx.slab_store.get(int(idx.fingerprints(toks)[0, 0]))
        assert tuple(slab["groups"]["b5"]["k"].shape) == (1, 1, 16, 4, 32)
        assert isinstance(slab["groups"]["b0"]["v"], torch.Tensor)
    finally:
        q.close()
