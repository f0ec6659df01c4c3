"""Parity: the port's transformer (reduced yi-9b) against the JAX
reference, with JAX's own weights carried across by
``transformer.params_from_numpy``.

Both sides run bf16; outputs must agree within ``rtol=1e-2, atol=5e-2``
(the reference's own non-exact bound, tests/test_decode_resume.py), and
greedy tokens must be identical wherever the reference's top-1/top-2
logit gap exceeds 0.1.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.models import transformer as t_tf

RTOL, ATOL = 1e-2, 5e-2
MARGIN = 0.1
N_LAYERS = 2
MAX_SEQ = 64


def _cfgs():
    j = dataclasses.replace(j_configs.get_arch("yi-9b").reduced(),
                            n_layers=N_LAYERS)
    t = dataclasses.replace(t_configs.get_arch("yi-9b").reduced(),
                            n_layers=N_LAYERS)
    return j, t


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, msg):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _tree_close(got: dict, want: dict, msg):
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, f"{msg}/{k}")
        else:
            assert tuple(got[k].shape) == tuple(v.shape), (msg, k)
            _close(got[k], v, f"{msg}/{k}")


def _top2_gap(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def assert_greedy_agree(got, want, gaps):
    """Row by row, tokens must match until the first step whose reference
    top-1/top-2 gap is within MARGIN; after a permitted divergence the row
    is not compared further."""
    got, want, gaps = np.asarray(got), np.asarray(want), np.asarray(gaps)
    for r in range(want.shape[0]):
        for t in range(want.shape[1]):
            if got[r, t] != want[r, t]:
                assert gaps[r, t] <= MARGIN, (r, t, gaps[r, t])
                break


def _tokens(s, vocab, seed=0, b=2):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def test_params_carry_across_exactly(models):
    jcfg, tcfg, jp, tp = models
    assert tp["groups"]["b0"]["attn"]["wq"].shape[0] == N_LAYERS
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert t_tf.param_count(tp) == sum(x.size for _, x in flat)
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(node.float().numpy(), _f32(leaf))


@pytest.mark.parametrize("s", [40, 48])
def test_full_prefill_matches(models, s):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(s, tcfg.vocab_size)
    jl, jc, jkv = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               MAX_SEQ, return_kv=True)
    tl, tc, tkv = t_tf.prefill(tp, tcfg, {"tokens": toks}, MAX_SEQ,
                               return_kv=True)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl, "logits")
    _tree_close(tc, jc, "cache")
    _tree_close(tkv, jkv, "kv")


@pytest.mark.parametrize("s,p_chunks", [(40, 1), (48, 2)])
def test_resumed_prefill_matches(models, s, p_chunks):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(s, tcfg.vocab_size, seed=1)
    p = 16 * p_chunks
    _, _, jkv = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             MAX_SEQ, return_kv=True)
    tfull_l, tfull_c, tkv = t_tf.prefill(tp, tcfg, {"tokens": toks},
                                         MAX_SEQ, return_kv=True)
    jpre = jax.tree.map(lambda a: a[:, :, :p], jkv)
    tpre = {"groups": {"b0": {k: v[:, :, :p] for k, v in
                              tkv["groups"]["b0"].items()}}}
    jl, jc, jsuf = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, p:])},
                                MAX_SEQ, prefix_kv=jpre, return_kv=True)
    tl, tc, tsuf = t_tf.prefill(tp, tcfg, {"tokens": toks[:, p:]}, MAX_SEQ,
                                prefix_kv=tpre, return_kv=True)
    _close(tl, jl, "resumed logits vs reference")
    _tree_close(tc, jc, "resumed cache vs reference")
    _tree_close(tsuf, jsuf, "resumed kv vs reference")
    # and the port's resume against the port's own full prefill
    _close(tl, tfull_l, "resumed vs full logits")
    _tree_close(tc, tfull_c, "resumed vs full cache")


def test_greedy_decode_matches(models):
    jcfg, tcfg, jp, tp = models
    s, n = 48, 3
    toks = _tokens(s, tcfg.vocab_size, seed=2)
    jl, jc = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    tl, tc = t_tf.prefill(tp, tcfg, {"tokens": toks}, MAX_SEQ)
    want, got, gaps = [], [], []
    for t in range(n):
        jl_np = np.asarray(jl)
        want.append(jl_np.argmax(-1))
        got.append(tl.argmax(-1).numpy())
        gaps.append(_top2_gap(jl_np))
        _close(tl, jl, f"decode step {t} logits")
        # feed the reference's token to both so later logits compare
        nxt = want[-1].astype(np.int32)[:, None]
        jl, jc = j_tf.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                  jnp.int32(s + t))
        tl, tc = t_tf.decode_step(tp, tcfg, nxt, tc, s + t)
    assert_greedy_agree(np.stack(got, 1), np.stack(want, 1),
                        np.stack(gaps, 1))


def test_unported_layer_kinds_raise():
    gemma = t_configs.get_arch("gemma3-27b").reduced()
    with pytest.raises(NotImplementedError, match="not ported"):
        t_tf.init_params(gemma, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        t_tf.init_params(t_configs.get_arch("qwen3-moe-30b-a3b").reduced(),
                         device="cpu")


def test_init_params_on_device_scales():
    """The port's own init: seeded, dense_init scales, zero norms."""
    _, tcfg = _cfgs()
    a = t_tf.init_params(tcfg, seed=3, device="cpu")
    b = t_tf.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(a["embed"]["embed"], b["embed"]["embed"])
    assert float(a["embed"]["embed"].float().std()) == pytest.approx(
        0.02, rel=0.1)
    wq = a["groups"]["b0"]["attn"]["wq"].float()
    assert float(wq.std()) == pytest.approx(tcfg.d_model ** -0.5, rel=0.1)
    assert not a["groups"]["b0"]["ln1"].any()
