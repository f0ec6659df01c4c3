"""Parity: the port's whole stack for the SSM and hybrid models (reduced
falcon-mamba-7b: 4 Mamba-1 layers; reduced zamba2-2.7b: 2 groups of
[Mamba-2, Mamba-2, shared attention], and 7 layers with a Mamba-2
remainder block), the training forward on embeddings (hubert's frames,
paligemma's image prefix) and the three losses, against the JAX reference
on its own weights carried across by ``transformer.params_from_numpy``.

Tolerances: bf16 outputs and logits within ``rtol=1e-2, atol=5e-2`` (the
reference's non-exact bound); the caches' float32 SSM states within
``rtol=1e-2, atol=1e-2``, a stated bound: the bf16 projections that feed
them round differently in the two packages' GEMMs (measured max |diff|
4.3e-3 over six prompts); greedy tokens equal wherever the reference's
top-1/top-2 gap exceeds 0.1; losses within ``rtol=1e-4``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from test_torch_model import _top2_gap, assert_greedy_agree

RTOL, ATOL = 1e-2, 5e-2
H_RTOL, H_ATOL = 1e-2, 1e-2
N_DECODE = 8

#: name -> (arch, n_layers or None for the reduced default)
MODELS = {"falcon": ("falcon-mamba-7b", None),
          "zamba2": ("zamba2-2.7b", None),
          "zamba2_rem": ("zamba2-2.7b", 7)}


def _cfgs(arch: str, n_layers=None, **kw):
    out = []
    for c in (j_configs, t_configs):
        cfg = c.get_arch(arch).reduced()
        if n_layers:
            kw = dict(kw, n_layers=n_layers)
        out.append(dataclasses.replace(cfg, **kw) if kw else cfg)
    return tuple(out)


def _carry(arch: str, n_layers=None, seed: int = 0, **kw):
    jcfg, tcfg = _cfgs(arch, n_layers, **kw)
    jp = j_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


@functools.cache
def _model(name: str):
    return (name,) + _carry(*MODELS[name])


@pytest.fixture(params=sorted(MODELS))
def model(request):
    return _model(request.param)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _cache_close(got: dict, want: dict, msg: str):
    for k, v in want.items():
        if isinstance(v, dict):
            _cache_close(got[k], v, f"{msg}/{k}")
            continue
        assert tuple(got[k].shape) == v.shape, (msg, k)
        assert str(got[k].dtype).endswith(str(v.dtype)), (msg, k)
        tol = dict(rtol=H_RTOL, atol=H_ATOL) if k == "h" else {}
        _close(got[k], v, f"{msg}/{k}", **tol)


def _tokens(s, vocab, seed=0, b=2):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def test_tree_and_dtypes_carry_across(model):
    name, jcfg, tcfg, jp, tp = model
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert t_tf.param_count(tp) == sum(x.size for _, x in flat)
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        assert str(node.dtype).endswith(str(leaf.dtype)), path
        np.testing.assert_array_equal(_f32(node), _f32(leaf))
    if jcfg.family == "hybrid":
        assert "shared" in tp and "b2" not in tp["groups"]
    # a leaf of the wrong dtype is refused
    bad = jax.tree.map(np.asarray, jp)
    group = bad["groups"]["b0"]["ssm"]
    group["a_log"] = group["a_log"].astype(np.float16)
    with pytest.raises(ValueError, match="a_log: dtype float16"):
        t_tf.params_from_numpy(bad, tcfg, device="cpu")


@pytest.mark.parametrize("name,s", [("falcon", 40), ("falcon", 96),
                                    ("zamba2", 40), ("zamba2", 96),
                                    ("zamba2_rem", 40)])
def test_full_prefill_matches(name, s):
    """40 tokens, and 96 (Mamba-1: a padded second chunk of 64)."""
    name, jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(s, tcfg.vocab_size, seed=s)
    jl, jc, jkv = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               s + N_DECODE, return_kv=True)
    tl, tc, tkv = t_tf.prefill(tp, tcfg, {"tokens": toks}, s + N_DECODE,
                               return_kv=True)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl, f"{name} logits")
    _cache_close(tc, jc, f"{name} cache")
    # the KV tree holds the attention blocks only
    want_kv = jax.tree.map(lambda a: a, jkv)
    want_kv = {k: ({b: v for b, v in g.items() if v is not None}
                   if k == "groups" else g)
               for k, g in want_kv.items() if g is not None}
    want_kv = {k: g for k, g in want_kv.items() if g}
    assert set(tkv) == set(want_kv)
    _cache_close(tkv, want_kv, f"{name} kv")


def test_greedy_decode_matches(model):
    """8 greedy decode steps from a 40-token prefill, the reference's
    token fed to both: logits within tolerance, the SSM states and the
    shared block's KV updated in place, tokens under the margin rule."""
    name, jcfg, tcfg, jp, tp = model
    s = 40
    toks = _tokens(s, tcfg.vocab_size, seed=2)
    jl, jc = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          s + N_DECODE)
    tl, tc = t_tf.prefill(tp, tcfg, {"tokens": toks}, s + N_DECODE)
    want, got, gaps = [], [], []
    for t in range(N_DECODE):
        jl_np = np.asarray(jl)
        want.append(jl_np.argmax(-1))
        got.append(tl.argmax(-1).numpy())
        gaps.append(_top2_gap(jl_np))
        _close(tl, jl, f"{name} decode step {t} logits")
        nxt = want[-1].astype(np.int32)[:, None]
        jl, jc = j_tf.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                  jnp.int32(s + t))
        tl2, tc2 = t_tf.decode_step(tp, tcfg, nxt, tc, s + t)
        assert tc2 is tc
        tl = tl2
    _cache_close(tc, jc, f"{name} cache after decode")
    assert_greedy_agree(np.stack(got, 1), np.stack(want, 1),
                        np.stack(gaps, 1))


def test_forward_every_position_matches(model):
    name, jcfg, tcfg, jp, tp = model
    toks = _tokens(40, tcfg.vocab_size, seed=5)
    want = j_tf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = t_tf.forward(tp, tcfg, {"tokens": toks})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want, f"{name} forward")


@pytest.mark.parametrize("arch", ["yi-9b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "qwen3-moe-30b-a3b"])
def test_decode_matches_forward(arch):
    """Mirror of tests/test_models.py::test_decode_matches_forward on the
    port: prefill(12) + decode_step logits against the full forward at the
    same positions (rtol 0.15/atol 0.2 at the prefill, rtol 0.2/atol 0.35
    per decode step; MoE rows at 0.35, half of them), argmax agreeing on
    at least 70% (50% at the prefill)."""
    jcfg, tcfg = _cfgs(arch)
    if tcfg.n_experts:
        kw = dict(capacity_factor=float(tcfg.n_experts))
        jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    b, prompt, total = 2, 12, 16
    toks = _tokens(total, tcfg.vocab_size, seed=11, b=b)
    x = t_tf.forward(tp, tcfg, {"tokens": toks})
    full = t_layers.unembed_logits(tp["embed"], x).numpy()
    pre, cache = t_tf.prefill(tp, tcfg, {"tokens": toks[:, :prompt]}, total)
    np.testing.assert_allclose(pre.numpy(), full[:, prompt - 1], rtol=0.15,
                               atol=0.2)
    assert (pre.numpy().argmax(-1) == full[:, prompt - 1].argmax(-1)
            ).mean() >= 0.5
    agree = 0
    for t in range(prompt, total):
        logits, cache = t_tf.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
        got, want = logits.numpy(), full[:, t]
        if tcfg.n_experts:
            assert (np.abs(got - want).max(axis=-1) < 0.35).mean() >= 0.5
        else:
            np.testing.assert_allclose(got, want, rtol=0.2, atol=0.35)
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    assert agree >= (total - prompt) * b * 0.7


def _embeds(b, p, d, seed):
    return np.random.default_rng(seed).standard_normal((b, p, d)).astype(
        np.float32)


def test_hubert_forward_on_embeds():
    """hubert: audio frames in, bidirectional attention, GELU MLP."""
    jcfg, tcfg, jp, tp = _carry("hubert-xlarge")
    assert not tcfg.causal and not tcfg.mlp_gated
    e = _embeds(2, 24, tcfg.d_model, 1)
    want = j_tf.forward(jp, jcfg, {"embeds": jnp.asarray(e, jnp.bfloat16)})
    got = t_tf.forward(tp, tcfg, {"embeds": torch.from_numpy(e)})
    _close(got, want, "hubert forward")
    # a frame at the end moves the first position: not causal
    e2 = e.copy()
    e2[:, -1] += 1.0
    moved = t_tf.forward(tp, tcfg, {"embeds": e2})
    assert not torch.equal(moved[:, 0], got[:, 0])


def test_paligemma_prefix_embeds_forward_and_prefill():
    """paligemma: the image prefix (P embeds) before the text tokens, in
    forward and in prefill; the decode after it attends to the prefix."""
    jcfg, tcfg, jp, tp = _carry("paligemma-3b")
    p = tcfg.n_prefix_embeds
    e = _embeds(2, p, tcfg.d_model, 2)
    toks = _tokens(24, tcfg.vocab_size, seed=3)
    jb = {"embeds": jnp.asarray(e, jnp.bfloat16), "tokens": jnp.asarray(toks)}
    tb = {"embeds": torch.from_numpy(e).to(torch.bfloat16), "tokens": toks}
    want = j_tf.forward(jp, jcfg, jb)
    got = t_tf.forward(tp, tcfg, tb)
    assert tuple(got.shape) == (2, p + 24, tcfg.d_model)
    _close(got, want, "paligemma forward")
    jl, jc = j_tf.prefill(jp, jcfg, jb, p + 24 + 2)
    tl, tc = t_tf.prefill(tp, tcfg, tb, p + 24 + 2)
    _close(tl, jl, "paligemma prefill logits")
    _cache_close(tc, jc, "paligemma cache")
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    jl, _ = j_tf.decode_step(jp, jcfg, jnp.asarray(nxt), jc, jnp.int32(p + 24))
    tl, _ = t_tf.decode_step(tp, tcfg, nxt, tc, p + 24)
    _close(tl, jl, "paligemma decode after the prefix")


@pytest.mark.parametrize("arch,seed", [
    pytest.param(a, 4, id=a) for a in ("yi-9b", "paligemma-3b",
                                       "hubert-xlarge", "zamba2-2.7b",
                                       "qwen3-moe-30b-a3b",
                                       "falcon-mamba-7b")] + [
    pytest.param("qwen3-moe-30b-a3b", s, id=f"qwen3-moe-30b-a3b-seed{s}")
    for s in (0, 1)])
def test_train_loss_matches(arch, seed):
    """The training loss, a VLM's over its text tail only, -1 labels
    masked; an MoE config adds no aux term (as the reference).

    qwen3-moe runs init seeds 4, 0 and 1 under the routing rule of
    ``tests/test_torch_train_grads.py``: where a token takes another
    expert than the reference's (a bf16 near-tie: its k-th/(k+1)-th
    router gap below the layer's max |logit difference|, asserted), the
    loss is held to ``FLIP_LOSS_RTOL = 5e-3`` instead of 1e-3.
    falcon-mamba also runs the backward through ``mamba1_block``'s
    selective scan, its gradients against ``jax.grad`` of the reference
    within the gradient bounds of that file."""
    from test_torch_train_grads import (FLIP_LOSS_RTOL, assert_grads_close,
                                        port_router_logits,
                                        port_value_and_grad,
                                        ref_router_logits,
                                        ref_value_and_grad, routing_flips)
    jcfg, tcfg, jp, tp = _carry(arch, seed=seed)
    rng = np.random.default_rng(6)
    s = 20
    labels = rng.integers(0, tcfg.vocab_size, (2, s)).astype(np.int32)
    labels[0, :3] = -1
    jb, tb = {"labels": jnp.asarray(labels)}, {"labels": labels}
    if tcfg.family == "audio":
        e = _embeds(2, s, tcfg.d_model, 7)
        jb["embeds"], tb["embeds"] = jnp.asarray(e, jnp.bfloat16), e
    else:
        toks = _tokens(s, tcfg.vocab_size, seed=8)
        jb["tokens"], tb["tokens"] = jnp.asarray(toks), toks
        if tcfg.family == "vlm":
            e = _embeds(2, tcfg.n_prefix_embeds, tcfg.d_model, 9)
            jb["embeds"], tb["embeds"] = jnp.asarray(e, jnp.bfloat16), e
    want = float(j_tf.train_loss(jp, jcfg, jb))
    got = t_tf.train_loss(tp, tcfg, tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    rel = 1e-3
    if tcfg.n_experts:
        flips = routing_flips(ref_router_logits(jcfg, jp, jb),
                              port_router_logits(tcfg, tp, tb), tcfg.top_k)
        rel = FLIP_LOSS_RTOL if flips else rel
    assert float(got) == pytest.approx(want, rel=rel)
    assert 0 < float(got) < 2 * np.log(tcfg.vocab_size)
    if arch == "falcon-mamba-7b":
        want_loss, want_g = ref_value_and_grad(jcfg, jp, jb)
        got_loss, paths, got_g = port_value_and_grad(tcfg, tp, tb)
        assert got_loss == pytest.approx(want_loss, rel=1e-3)
        assert_grads_close(paths, want_g, got_g, arch)
        ssm_grads = [g for p, g in zip(paths, got_g) if "ssm" in p]
        assert ssm_grads and all(np.isfinite(g).all() and np.abs(g).max() > 0
                                 for g in ssm_grads)


@pytest.mark.parametrize("s,chunk", [(37, 16), (16, 512), (40, 8)])
def test_chunked_ce_loss_matches(s, chunk):
    """S not a multiple of the chunk (the reference pads with -1 labels,
    the port's last chunk is short), masked labels, float32 logits."""
    jcfg, tcfg, jp, tp = _carry("yi-9b", n_layers=1)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, s)).astype(np.int32)
    labels[:, ::5] = -1
    want = float(j_layers.chunked_ce_loss(
        jp["embed"], jnp.asarray(x, jnp.bfloat16), jnp.asarray(labels),
        chunk=chunk))
    got = t_layers.chunked_ce_loss(
        tp["embed"], torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(labels).long(), chunk=chunk)
    assert float(got) == pytest.approx(want, rel=1e-4)
    all_masked = t_layers.chunked_ce_loss(
        tp["embed"], torch.from_numpy(x).to(torch.bfloat16),
        torch.full((2, s), -1), chunk=chunk)
    assert float(all_masked) == 0.0


def test_aux_load_balance_loss_matches():
    jcfg, tcfg, jp, tp = _carry("qwen3-moe-30b-a3b", n_layers=1)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    jm = jax.tree.map(lambda a: a[0], jp["groups"]["b0"]["moe"])
    tm = t_tf._block(tp, "b0", 0)["moe"]
    want = float(j_moe.aux_load_balance_loss(
        jm, jnp.asarray(x, jnp.bfloat16), jcfg))
    got = t_moe.aux_load_balance_loss(
        tm, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(got) > 0
