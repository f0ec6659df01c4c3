"""Parity: the port's transformer (reduced yi-9b, and reduced gemma3 with
its local/global layer groups, remainder blocks and ring caches) against
the JAX reference, with JAX's own weights carried across by
``transformer.params_from_numpy``; and every arch's reduced config built
with the reference's parameter and cache trees.

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
from repro_torch.pytree import tree_map

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


def _leaf_specs(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of (shape, torch dtype)
    pairs or of arrays (JAX shape structs, tensors)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, tuple):
            out[path] = (tuple(t[0]), str(t[1]).replace("torch.", ""))
        else:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS))
def test_every_arch_builds_with_the_reference_tree(arch):
    """Every block kind is ported: each arch's reduced config builds its
    parameters, caches and parameter count, and ``param_shapes`` is the
    reference's ``init_params`` tree (``jax.eval_shape``), shapes and
    dtypes, as are the built parameters and caches."""
    jcfg = j_configs.get_arch(arch).reduced()
    tcfg = t_configs.get_arch(arch).reduced()
    want = _leaf_specs(jax.eval_shape(
        lambda: j_tf.init_params(jax.random.PRNGKey(0), jcfg)))
    assert _leaf_specs(t_tf.param_shapes(tcfg)) == want
    params = t_tf.init_params(tcfg, device="cpu")
    assert _leaf_specs(params) == want
    assert t_tf.param_count(params) == sum(
        int(np.prod(s)) for s, _ in want.values())
    assert _leaf_specs(t_tf.init_cache(tcfg, 2, 40, device="cpu")) == \
        _leaf_specs(jax.eval_shape(lambda: j_tf.init_cache(jcfg, 2, 40)))


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS))
def test_every_arch_runs_forward_prefill_decode(arch):
    """Every reduced config runs ``forward``, ``prefill`` and one
    ``decode_step`` on its own seeded weights, on tokens, on embeddings
    (hubert's frames) or on both (paligemma's image prefix): the shapes
    the reference gives and finite values."""
    cfg = t_configs.get_arch(arch).reduced()
    params = t_tf.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    b, s = 2, 20
    batch = {}
    if cfg.family in ("vlm", "audio"):
        p = cfg.n_prefix_embeds if cfg.family == "vlm" else s
        batch["embeds"] = rng.standard_normal((b, p, cfg.d_model)).astype(
            np.float32)
    if cfg.family != "audio":
        batch["tokens"] = rng.integers(1, cfg.vocab_size, (b, s))
    total = sum(v.shape[1] for v in batch.values())
    x = t_tf.forward(params, cfg, batch)
    assert tuple(x.shape) == (b, total, cfg.d_model)
    assert torch.isfinite(x.float()).all()
    logits, cache = t_tf.prefill(params, cfg, batch, total + 1)
    assert tuple(logits.shape) == (b, cfg.vocab_size)
    logits, cache = t_tf.decode_step(params, cfg, logits.argmax(-1)[:, None],
                                     cache, total)
    assert tuple(logits.shape) == (b, cfg.vocab_size)
    assert torch.isfinite(logits).all()


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


# ---------------------------------------------------------------------------
# gemma3: local (sliding-window) layers, multi-kind groups, remainders.
# ---------------------------------------------------------------------------

#: reduced gemma3 (window 32): 4 layers all local (no group, rem0..rem3);
#: 6 layers, one [local x 5, global] group; 8 layers, the group plus two
#: local remainder blocks.
GEMMA_LAYERS = {"local": 4, "mixed": 6, "mixed8": 8}


def gemma_cfgs(kind: str, use_rope: bool = True):
    n = GEMMA_LAYERS[kind]
    return tuple(dataclasses.replace(c.get_arch("gemma3-27b").reduced(),
                                     n_layers=n, use_rope=use_rope)
                 for c in (j_configs, t_configs))


def gemma_models(kind: str, use_rope: bool = True, seed: int = 1):
    jcfg, tcfg = gemma_cfgs(kind, use_rope)
    jp = j_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=sorted(GEMMA_LAYERS))
def gemma(request):
    return (request.param,) + gemma_models(request.param)


def test_gemma_tree_and_params_carry_across(gemma):
    kind, jcfg, tcfg, jp, tp = gemma
    group, n_groups, rem = tcfg.scan_groups()
    want = ({"groups"} if n_groups else set()) | {f"rem{i}" for i in
                                                  range(len(rem))}
    assert set(tp) == {"embed", "final_ln"} | want
    if n_groups:
        assert sorted(tp["groups"]) == [f"b{i}" for i in range(len(group))]
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert t_tf.param_count(tp) == sum(x.size for _, x in flat)
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.float().numpy(), _f32(leaf))
    # the port's own init builds the same tree
    mine = t_tf.init_params(tcfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jp))


def test_gemma_cache_rings():
    """Local blocks get a ring of min(max_seq, window) slots, global
    blocks max_seq, in the reference's tree."""
    jcfg, tcfg = gemma_cfgs("mixed8")
    for max_seq in (20, 80):
        jc = j_tf.init_cache(jcfg, 2, max_seq)
        tc = t_tf.init_cache(tcfg, 2, max_seq, device="cpu")
        assert jax.tree.map(lambda a: a.shape, jc) == \
            tree_map(lambda a: tuple(a.shape), tc)
    assert tc["groups"]["b0"]["k"].shape == (1, 2, 32, 4, 32)
    assert tc["groups"]["b5"]["k"].shape == (1, 2, 80, 4, 32)
    assert tc["rem1"]["k"].shape == (2, 32, 4, 32)


@pytest.mark.parametrize("s", [40, 48])
def test_gemma_full_prefill_matches(gemma, s):
    """Logits, every cache leaf (ring slots included: S > window) and the
    returned KV against the reference."""
    kind, jcfg, tcfg, jp, tp = gemma
    toks = _tokens(s, tcfg.vocab_size, seed=s)
    jl, jc, jkv = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               MAX_SEQ, return_kv=True)
    tl, tc, tkv = t_tf.prefill(tp, tcfg, {"tokens": toks}, MAX_SEQ,
                               return_kv=True)
    _close(tl, jl, f"{kind} logits")
    _tree_close(tc, jc, f"{kind} cache")
    _tree_close(tkv, jkv, f"{kind} kv")


def test_gemma_greedy_decode_matches(gemma):
    """3 decode steps past a wrapped ring (S=48 > window 32), the
    reference's token fed to both, logits within tolerance and greedy
    tokens under the margin rule."""
    kind, jcfg, tcfg, jp, tp = gemma
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
        _close(tl, jl, f"{kind} decode step {t} logits")
        nxt = want[-1].astype(np.int32)[:, None]
        jl, jc = j_tf.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                  jnp.int32(s + t))
        tl, tc = t_tf.decode_step(tp, tcfg, nxt, tc, s + t)
    _tree_close(tc, jc, f"{kind} cache after decode")
    assert_greedy_agree(np.stack(got, 1), np.stack(want, 1),
                        np.stack(gaps, 1))


@pytest.mark.parametrize("local", [False, True])
def test_gemma_attention_block_matches(local):
    """``layers.attention_block`` (S = 48 > window 32) against the
    reference's, on the first block's weights."""
    from repro.models import layers as j_layers
    from repro_torch.models import layers as t_layers
    jcfg, tcfg, jp, tp = gemma_models("local")
    x = np.random.default_rng(5).standard_normal((2, 48, tcfg.d_model))
    pos = np.broadcast_to(np.arange(48)[None], (2, 48))
    want = j_layers.attention_block(
        jp["rem0"]["attn"], jnp.asarray(x, jnp.bfloat16), jcfg,
        jnp.asarray(pos), local=local)
    got = t_layers.attention_block(
        tp["rem0"]["attn"], torch.from_numpy(x).to(torch.bfloat16), tcfg,
        torch.from_numpy(pos.copy()), local=local)
    _close(got, want, f"attention_block local={local}")
