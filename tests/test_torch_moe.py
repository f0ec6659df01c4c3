"""Parity: the port's MoE block and MoE decoder (reduced qwen3-moe and
reduced arctic with its dense residual) against the JAX reference, with
JAX's weights carried across.

The routing is compared exactly where it is decided by more than
float32 noise: the chosen experts must be the reference's wherever the
gap between the k-th and the (k+1)-th router probability exceeds
``ROUTE_MARGIN`` (the set of the k), and in the reference's order where
every adjacent gap of the top k+1 exceeds it.  bf16 outputs must agree
within ``rtol=1e-2, atol=5e-2``; greedy tokens must be identical
wherever the reference's top-1/top-2 logit gap exceeds 0.1.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.launch import httpd
from repro_torch.launch import serve as t_serve
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.pytree import tree_map
from test_torch_model import _top2_gap, assert_greedy_agree

RTOL, ATOL = 1e-2, 5e-2
ROUTE_MARGIN = 1e-6
QWEN, ARCTIC = "qwen3-moe-30b-a3b", "arctic-480b"
MAX_SEQ = 64
#: capacity_factor per case: 0.5 binds (drops entries), n_experts never
#: binds (C >= the group's tokens).
CAPACITY = {"binding": 0.5, "free": 8.0}


def _cfgs(arch: str, **kw):
    return (dataclasses.replace(j_configs.get_arch(arch).reduced(), **kw),
            dataclasses.replace(t_configs.get_arch(arch).reduced(), **kw))


def _moe_params(jcfg, seed=0):
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = tree_map(lambda a: t_tf._to_tensor(np.asarray(a), "cpu"), jp)
    return jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_routing(jp, x, cfg):
    """The reference's top-k ids and router probabilities."""
    logits = jnp.einsum("gnd,de->gne", x.astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, ix = jax.lax.top_k(probs, cfg.top_k)
    return np.asarray(ix), np.asarray(probs)


def assert_routing_agrees(got_ix, want_ix, probs, k):
    """Chosen experts equal where the k-th/(k+1)-th gap exceeds the
    margin, in order where every adjacent gap of the top k+1 does."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    gaps = top[..., :-1] - top[..., 1:]
    decided = gaps[..., k - 1] > ROUTE_MARGIN
    ordered = (gaps > ROUTE_MARGIN).all(-1)
    got, want = np.asarray(got_ix), np.asarray(want_ix)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(np.sort(got, -1)[decided],
                                  np.sort(want, -1)[decided])
    np.testing.assert_array_equal(got[ordered], want[ordered])


def _drops(cfg, ix: np.ndarray, s: int) -> int:
    """Entries past capacity: per group, each expert keeps ``C``."""
    c = t_moe.capacity(cfg, s)
    return int(sum(max(n - c, 0) for g in ix
                   for n in np.bincount(g.reshape(-1),
                                        minlength=cfg.n_experts)))


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("arch", [QWEN, ARCTIC])
def test_moe_block_matches_reference(arch, dispatch, capacity):
    jcfg, tcfg = _cfgs(arch, moe_dispatch=dispatch,
                       capacity_factor=CAPACITY[capacity])
    assert tcfg.dense_residual == (arch == ARCTIC)
    jp, tp = _moe_params(jcfg)
    s = 40
    x = _x((2, s, jcfg.d_model), seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = j_moe.moe_block(jp, xj, jcfg)
    got, ix, probs = t_moe.moe_block(
        tp, torch.from_numpy(x).to(torch.bfloat16), tcfg,
        return_routing=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    want_ix, want_probs = _ref_routing(jp, xj, jcfg)
    np.testing.assert_allclose(probs.numpy(), want_probs, rtol=1e-5,
                               atol=1e-7)
    assert_routing_agrees(ix.numpy(), want_ix, want_probs, tcfg.top_k)
    drops = _drops(tcfg, want_ix, s)
    assert (drops > 0) == (capacity == "binding"), drops
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", [QWEN, ARCTIC])
def test_moe_decode_step_shape_matches_reference(arch):
    """S = 1 (a decode step): capacity 1, nothing dropped."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, seed=2)
    x = _x((3, 1, jcfg.d_model), seed=3)
    assert t_moe.capacity(tcfg, 1) == j_moe.capacity(jcfg, 1) == 1
    want = j_moe.moe_block(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got = t_moe.moe_block(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s", [1, 7, 16, 40, 96])
def test_capacity_matches_reference(s):
    for arch in (QWEN, ARCTIC):
        for full in (True, False):
            j = j_configs.get_arch(arch)
            t = t_configs.get_arch(arch)
            if not full:
                j, t = j.reduced(), t.reduced()
            assert t_moe.capacity(t, s) == j_moe.capacity(j, s)
    # the full-width qwen3-moe numbers the card runs
    assert t_moe.capacity(t_configs.get_arch(QWEN), 96) == 7
    assert t_moe.capacity(t_configs.get_arch(QWEN), 48) == 3


def test_moe_einsum_dispatch_matches_gather(rng):
    """The einsum path equals the gather path (the reference's own pin,
    float32 activations), binding and non-binding capacity."""
    _, cfg = _cfgs(QWEN)
    _, tp = _moe_params(_cfgs(QWEN)[0])
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model)) * 0.5).float()
    for cf in (1.25, float(cfg.n_experts)):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        y_g = t_moe._moe_block_gather(tp, x, c)[0]
        y_e = t_moe._moe_block_einsum(tp, x, c)[0]
        np.testing.assert_allclose(y_g.numpy(), y_e.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_moe_dispatch_flag_routes(monkeypatch):
    _, cfg = _cfgs(QWEN, moe_dispatch="einsum")
    _, tp = _moe_params(_cfgs(QWEN)[0])
    calls = []
    real = t_moe._moe_block_einsum
    monkeypatch.setattr(t_moe, "_moe_block_einsum",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    assert t_moe.moe_block(tp, x, cfg).shape == x.shape
    assert calls == [1]


def test_moe_capacity_and_dispatch(rng):
    """The reference's case: finite output, permutation-equivariance when
    capacity does not bind, and binding capacity shrinks the output."""
    _, cfg = _cfgs(QWEN)
    _, tp = _moe_params(_cfgs(QWEN)[0])
    b, s = 2, 16
    x = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model))).to(
        torch.bfloat16)
    y = t_moe.moe_block(tp, x, cfg)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    assert t_moe.capacity(cfg, s) >= 1
    cfg_nb = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    y_nb = t_moe.moe_block(tp, x, cfg_nb)
    perm = torch.from_numpy(rng.permutation(s))
    y_perm = t_moe.moe_block(tp, x[:, perm], cfg_nb)
    np.testing.assert_allclose(y_nb[:, perm].float().numpy(),
                               y_perm.float().numpy(), rtol=0.35, atol=0.35)
    assert (float(y.float().abs().sum())
            <= float(y_nb.float().abs().sum()) * 1.25)


def test_combine_is_deterministic():
    """Two runs of a binding-capacity block give the same bits."""
    _, cfg = _cfgs(QWEN, capacity_factor=0.5)
    _, tp = _moe_params(_cfgs(QWEN)[0], seed=4)
    x = torch.from_numpy(_x((2, 24, cfg.d_model), seed=5)).to(torch.bfloat16)
    a = t_moe.moe_block(tp, x, cfg)
    assert torch.equal(a, t_moe.moe_block(tp, x, cfg))
    assert torch.isfinite(a.float()).all()


# ---------------------------------------------------------------------------
# The decoder with MoE blocks.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_models():
    jcfg, tcfg = _cfgs(QWEN)
    jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(s, vocab, seed=0, b=2):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def test_moe_tree_carries_across_exactly(qwen_models):
    jcfg, tcfg, jp, tp = qwen_models
    assert tcfg.n_layers == 4 and tcfg.n_experts == 8 and tcfg.top_k == 2
    assert "moe" in tp["groups"]["b0"] and "mlp" not in tp["groups"]["b0"]
    assert tp["groups"]["b0"]["moe"]["w_up"].shape == (4, 8, 128, 64)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert t_tf.param_count(tp) == sum(x.size for _, x in flat)
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.float().numpy(), _f32(leaf))


def test_moe_init_params_scales():
    """The port's own init draws the reference's tree and scales."""
    _, tcfg = _cfgs(ARCTIC)
    p = t_tf.init_params(tcfg, seed=1, device="cpu")
    m = p["groups"]["b0"]["moe"]
    assert sorted(m) == ["dense", "router", "w_down", "w_gate", "w_up"]
    assert float(m["router"].float().std()) == pytest.approx(0.02, rel=0.1)
    assert float(m["w_up"].float().std()) == pytest.approx(
        tcfg.n_experts ** -0.5, rel=0.1)
    own = t_moe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert tree_map(lambda a: tuple(a.shape), own) == t_moe.moe_shapes(tcfg)


@pytest.mark.parametrize("s", [40, 48])
def test_moe_prefill_and_decode_match(qwen_models, s):
    jcfg, tcfg, jp, tp = qwen_models
    toks = _tokens(s, tcfg.vocab_size, seed=s)
    jl, jc = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    tl, tc = t_tf.prefill(tp, tcfg, {"tokens": toks}, MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            _f32(tc["groups"]["b0"][key]), _f32(jc["groups"]["b0"][key]),
            rtol=RTOL, atol=ATOL)
    want, got, gaps = [], [], []
    for t in range(6):
        jl_np = np.asarray(jl)
        want.append(jl_np.argmax(-1))
        got.append(tl.argmax(-1).numpy())
        gaps.append(_top2_gap(jl_np))
        np.testing.assert_allclose(tl.numpy(), jl_np, rtol=RTOL, atol=ATOL,
                                   err_msg=f"decode step {t}")
        nxt = want[-1].astype(np.int32)[:, None]
        jl, jc = j_tf.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                  jnp.int32(s + t))
        tl, tc = t_tf.decode_step(tp, tcfg, nxt, tc, s + t)
    assert_greedy_agree(np.stack(got, 1), np.stack(want, 1),
                        np.stack(gaps, 1))


@pytest.mark.parametrize("p", [16, 32])
def test_moe_resumed_prefill_matches_reference_resume(qwen_models, p):
    """Resumed prefill is held to the reference's resumed prefill: the
    suffix's capacity follows the suffix's length, so for MoE a resumed
    prefill is not the full prefill, in the reference as in the port."""
    jcfg, tcfg, jp, tp = qwen_models
    toks = _tokens(48, tcfg.vocab_size, seed=9)
    _, _, jkv = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :p])},
                             MAX_SEQ, return_kv=True)
    jpk = jax.tree.map(lambda a: a[..., :p, :, :], jkv)
    jl, jc = j_tf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, p:])},
                          MAX_SEQ, prefix_kv=jpk)
    tpk = tree_map(lambda a: t_tf._to_tensor(np.asarray(a), "cpu"),
                   jax.tree.map(np.asarray, jpk))
    tl, tc = t_tf.prefill(tp, tcfg, {"tokens": toks[:, p:]}, MAX_SEQ,
                          prefix_kv=tpk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_f32(tc["groups"]["b0"]["k"]),
                               _f32(jc["groups"]["b0"]["k"]), rtol=RTOL,
                               atol=ATOL)
    clear = _top2_gap(np.asarray(jl)) > 0.1
    np.testing.assert_array_equal(tl.numpy().argmax(-1)[clear],
                                  np.asarray(jl).argmax(-1)[clear])
    assert t_moe.capacity(tcfg, 48 - p) < t_moe.capacity(tcfg, 48)


# ---------------------------------------------------------------------------
# The launchers, end to end on the CPU.
# ---------------------------------------------------------------------------

def test_serve_qwen3_moe_with_four_shards(capsys):
    records = t_serve.main(["--arch", QWEN, "--reduced", "--device", "cpu",
                            "--n-shards", "4", "--requests", "6",
                            "--decode-tokens", "2", "--sync-admit"])
    assert len(records) == 3
    assert all(r.decoded.shape == (2, 2) for r in records)
    assert sum(r.resumed_chunks for r in records) > 0
    out = capsys.readouterr().out
    assert "sharded over 4 set shards (2 sets each; co-located" in out


def test_httpd_qwen3_moe_with_four_shards():
    import http.client
    import json

    args = httpd.build_parser().parse_args(
        ["--arch", QWEN, "--reduced", "--device", "cpu", "--port", "0",
         "--prompt-len", "48", "--decode-tokens", "3", "--batch-window-ms",
         "0", "--admit-after-reads", "0", "--n-shards", "4"])
    fe, q = httpd.build_frontend(args)
    fe.start()
    host, port = fe.address
    prefix = _tokens(32, 512, seed=1, b=1)[0]
    answers = []
    try:
        for seed in (2, 3):
            toks = np.concatenate([np.tile(prefix, (2, 1)),
                                   _tokens(16, 512, seed=seed)], axis=1)
            conn = http.client.HTTPConnection(host, port, timeout=120)
            conn.request("POST", "/v1/generate",
                         json.dumps({"tokens": toks.tolist()}))
            resp = conn.getresponse()
            assert resp.status == 200
            answers.append(json.loads(resp.read()))
            conn.close()
    finally:
        fe.shutdown()
        q.close()
    assert q.index.n_shards == 4 and q.index.n_parts == 1
    assert answers[1]["resumed_chunks"] == 4     # 2 prefix chunks x 2 rows
    assert all(np.asarray(a["tokens"]).shape == (2, 3) for a in answers)
