"""Parity of the training gradients: the port's ``train_loss`` on the
float32 masters cast by ``train.step.cast_bf16``, differentiated by
autograd, against the reference's ``jax.jit(jax.value_and_grad(...))``
of the same function on the same masters (its ``init_state`` carried
across by ``train.step.state_from_numpy``), for the seven reduced archs
of the port's model families.

Bounds, stated once for every arch:

* the loss within ``LOSS_RTOL = 1e-3`` relative;
* every leaf's gradient within ``GRAD_RTOL = 5e-2`` relative L2 error
  (``|g_port - g_ref| / |g_ref|``): the backward passes run in bf16 with
  bf16 leaf gradients, which the two packages round in other places.
  Measured on these inputs, the worst leaf: 1.2-1.8% for yi, falcon-mamba,
  paligemma, hubert and qwen3-moe, 3.0% for zamba2 (a stacked ``dt_b``),
  3.2% for gemma3 (a remainder attention block, which the reference runs
  op by op beside its compiled group);
* all leaves together within ``TOTAL_RTOL = 4e-2`` (measured 0.9-1.6%,
  gemma3 2.5%).

qwen3-moe runs init seeds 0, 1 and 4 under the routing rule: each
layer's top-k expert ids are recorded in both packages (a forward of the
same cast masters).  Where every layer routes alike the gradients are
held to the bounds above.  Where a token takes another expert, its
k-th/(k+1)-th router-logit gap must be below the largest |logit
difference| of that layer — a bf16 near-tie, not a port fault — and the
loss is held to ``FLIP_LOSS_RTOL = 5e-3`` instead (the gradients of a
token routed elsewhere are another function's).  On this batch
(``MOE_BATCH_SEED``) init seed 0 flips one token in layer 1 (gap 2.7e-4
against a max |dlogit| of 1.8e-3), which then routes differently in
layers 2 and 3 too: loss 6.6e-4 relative, gradients 14% apart.  Seeds 1
and 4 route alike: loss within 8e-5, worst leaf 1.5-1.8%.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.train import step as j_step
from repro_torch import configs as t_configs
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.pytree import tree_paths
from repro_torch.train import step as t_step

LOSS_RTOL = 1e-3
GRAD_RTOL = 5e-2
TOTAL_RTOL = 4e-2
FLIP_LOSS_RTOL = 5e-3
B, S = 2, 32
MOE_BATCH_SEED = 3


def make_batch(cfg, seed: int = 1, b: int = B, s: int = S):
    """(reference batch, port batch) of seeded numpy tokens/labels, an
    audio model's frames or a VLM's prefix embeddings."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    jb, tb = {"labels": jnp.asarray(labels)}, {"labels": labels}
    if cfg.family == "audio":
        e = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        jb["embeds"] = jnp.asarray(e, jnp.bfloat16)
        tb["embeds"] = torch.from_numpy(e).to(torch.bfloat16)
        return jb, tb
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    jb["tokens"], tb["tokens"] = jnp.asarray(toks), toks
    if cfg.family == "vlm":
        e = rng.standard_normal((b, cfg.n_prefix_embeds,
                                 cfg.d_model)).astype(np.float32)
        jb["embeds"] = jnp.asarray(e, jnp.bfloat16)
        tb["embeds"] = torch.from_numpy(e).to(torch.bfloat16)
    return jb, tb


def carry_state(arch: str, seed: int, **kw):
    """(reference cfg, port cfg, reference state, port state on the CPU)
    for the reduced ``arch``."""
    import dataclasses
    jcfg = j_configs.get_arch(arch).reduced()
    tcfg = t_configs.get_arch(arch).reduced()
    if kw:
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
    jst = j_step.init_state(jax.random.PRNGKey(seed), jcfg)
    tst = t_step.state_from_numpy(jax.tree.map(np.asarray, jst), tcfg,
                                  device="cpu")
    return jcfg, tcfg, jst, tst


def ref_value_and_grad(jcfg, params, batch):
    f = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.train_loss(j_step.cast_bf16(p), jcfg, b)))
    loss, grads = f(params, batch)
    return float(loss), [np.asarray(g, np.float32) for _, g in
                         tree_paths(jax.tree.map(np.asarray, grads))]


def port_value_and_grad(tcfg, params, batch):
    """The port's loss, leaf paths and gradients (float32 numpy), in the
    reference's leaf order, from the train step's ``loss_and_grads``."""
    loss, grads = t_step.loss_and_grads(tcfg, params, batch)
    pairs = tree_paths(grads)
    return (float(loss), [p for p, _ in pairs],
            [g.float().numpy() for _, g in pairs])


def grad_errors(want, got) -> tuple[list, float]:
    """Per-leaf relative L2 errors and the error of all leaves together."""
    per = [float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
           for w, g in zip(want, got)]
    num = np.sqrt(sum(float(np.sum((g - w) ** 2)) for w, g in zip(want, got)))
    den = np.sqrt(sum(float(np.sum(w ** 2)) for w in want))
    return per, float(num / den)


def assert_grads_close(paths, want, got, what: str) -> None:
    per, total = grad_errors(want, got)
    worst = int(np.argmax(per))
    assert per[worst] <= GRAD_RTOL, (what, "/".join(paths[worst]), per[worst])
    assert total <= TOTAL_RTOL, (what, total)


# ---------------------------------------------------------------------------
# Routing records (qwen3-moe).
# ---------------------------------------------------------------------------

def ref_router_logits(jcfg, params, batch) -> list:
    """Each MoE layer's (B, S, E) float32 router logits, in layer order,
    from the jitted reference forward of the cast masters."""
    got = []
    orig = j_moe.moe_block

    def rec(p, x, cfg):
        logits = jnp.einsum("gnd,de->gne", x.astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        jax.debug.callback(lambda a: got.append(np.asarray(a)), logits,
                           ordered=True)
        return orig(p, x, cfg)

    j_moe.moe_block = rec
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: j_tf.train_loss(j_step.cast_bf16(p), jcfg, b))(
                params, batch))
        jax.effects_barrier()
    finally:
        j_moe.moe_block = orig
    return got


def port_router_logits(tcfg, params, batch) -> list:
    got = []
    orig = t_moe.moe_block

    def rec(p, x, cfg, **kw):
        got.append((x.float() @ p["router"].float()).numpy())
        return orig(p, x, cfg, **kw)

    t_moe.moe_block = rec
    try:
        with torch.no_grad():
            t_tf.train_loss(t_step.cast_bf16(params), tcfg, batch)
    finally:
        t_moe.moe_block = orig
    return got


def routing_flips(want: list, got: list, k: int) -> list:
    """``(layer, token index, k/k+1 gap, layer max |dlogit|)`` for every
    token whose top-k expert set differs; asserts each gap is below its
    layer's max |logit difference|."""
    assert len(want) == len(got) > 0
    flips = []
    for layer, (w, g) in enumerate(zip(want, got)):
        w = w.reshape(-1, w.shape[-1])
        g = g.reshape(-1, g.shape[-1])
        d_max = float(np.abs(w - g).max())
        top_w = np.sort(np.argsort(-w, axis=-1, kind="stable")[:, :k], -1)
        top_g = np.sort(np.argsort(-g, axis=-1, kind="stable")[:, :k], -1)
        for t in np.flatnonzero((top_w != top_g).any(-1)):
            srt = np.sort(w[t])[::-1]
            gap = float(srt[k - 1] - srt[k])
            flips.append((layer, int(t), gap, d_max))
            assert gap < d_max, ("a token took another expert with a "
                                 "router gap above the layer's |dlogit|",
                                 layer, t, gap, d_max)
    return flips


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------

ARCHS = ["yi-9b", "gemma3-27b", "falcon-mamba-7b", "zamba2-2.7b",
         "paligemma-3b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    jcfg, tcfg, jst, tst = carry_state(arch, seed=0)
    jb, tb = make_batch(tcfg)
    want_loss, want = ref_value_and_grad(jcfg, jst["params"], jb)
    got_loss, paths, got = port_value_and_grad(tcfg, tst["params"], tb)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_close(paths, want, got, arch)
    assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_moe_gradients_match_reference_under_routing_rule(seed):
    jcfg, tcfg, jst, tst = carry_state("qwen3-moe-30b-a3b", seed=seed)
    jb, tb = make_batch(tcfg, seed=MOE_BATCH_SEED)
    flips = routing_flips(ref_router_logits(jcfg, jst["params"], jb),
                          port_router_logits(tcfg, tst["params"], tb),
                          tcfg.top_k)
    want_loss, want = ref_value_and_grad(jcfg, jst["params"], jb)
    got_loss, paths, got = port_value_and_grad(tcfg, tst["params"], tb)
    assert all(np.isfinite(g).all() for g in got)
    if flips:
        assert got_loss == pytest.approx(want_loss, rel=FLIP_LOSS_RTOL)
    else:
        assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
        assert_grads_close(paths, want, got, f"qwen3-moe seed {seed}")


def test_mamba2_gradient_finite_where_the_decay_overflows():
    """A Mamba-2 chunk whose decay passes e^88 above the diagonal (large
    ``dt``, long chunk): the port masks the exponent before the exp, so
    its block output equals the reference's and its gradients are
    finite, where the reference's ``where(causal, exp(seg), 0)`` leaves
    ``0 * inf = NaN`` in the backward pass (zamba2-2.7b at S = 512 hits
    it with random weights)."""
    from repro.models import ssm as j_ssm
    from repro_torch.models import ssm as t_ssm

    jcfg, tcfg, jst, tst = carry_state("zamba2-2.7b", seed=0)
    pick = lambda a: a[0]
    jp = jax.tree.map(pick, j_step.cast_bf16(jst["params"])["groups"]["b0"]
                      ["ssm"])
    tp = {k: pick(v) for k, v in
          t_step.cast_bf16(tst["params"])["groups"]["b0"]["ssm"].items()}
    jp["dt_b"] = jnp.full(jp["dt_b"].shape, 4.0, jp["dt_b"].dtype)
    tp["dt_b"] = torch.full(tuple(tp["dt_b"].shape), 4.0,
                            dtype=tp["dt_b"].dtype)
    x = np.random.default_rng(0).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    want = j_ssm.mamba2_block(jp, jx, jcfg)
    got = t_ssm.mamba2_block(tp, tx, tcfg)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=5e-2)
    (gx,) = torch.autograd.grad(got.float().sum(), tx)
    assert torch.isfinite(gx).all() and gx.abs().max() > 0
    jgx = jax.grad(lambda a: j_ssm.mamba2_block(jp, a, jcfg).astype(
        jnp.float32).sum())(jx)
    assert np.isnan(np.asarray(jgx, np.float32)).any()
