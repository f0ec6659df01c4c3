"""Parity: the port's SSM blocks (``repro_torch/models/ssm.py``) against
the JAX reference's ``repro/models/ssm.py`` at reduced width, on the
reference's own weights carried across.

Tolerances: bf16 outputs within ``rtol=1e-2, atol=5e-2`` (the reference's
non-exact bound); the float32 states within ``rtol=1e-4, atol=1e-5``; the
bf16 conv taps exactly (they are raw projections).  Op by op (``fused=
False``) the port is held to the reference called eagerly; ``fused=True``
to the reference compiled whole by ``jax.jit``, as a layer group's scan
body runs it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ssm as j_ssm
from repro_torch import configs as t_configs
from repro_torch.models import ssm as t_ssm
from repro_torch.models.transformer import _to_tensor

RTOL, ATOL = 1e-2, 5e-2
S_RTOL, S_ATOL = 1e-4, 1e-5
CHUNK = 4
N_DECODE = 8

#: arch, block, decode step, init, sequence lengths (a padded chunk each)
KINDS = {
    "mamba1": ("falcon-mamba-7b", "mamba1_block", "mamba1_decode",
               "init_mamba1", (12, 10)),
    "mamba2": ("zamba2-2.7b", "mamba2_block", "mamba2_decode",
               "init_mamba2", (8, 11)),
}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, msg, state=False):
    rtol, atol = (S_RTOL, S_ATOL) if state else (RTOL, ATOL)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module", params=sorted(KINDS))
def block(request):
    arch, blk, dec, init, seqs = KINDS[request.param]
    jcfg = j_configs.get_arch(arch).reduced()
    tcfg = t_configs.get_arch(arch).reduced()
    jp = getattr(j_ssm, init)(jax.random.PRNGKey(0), jcfg)
    tp = {k: _to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    return (request.param, jcfg, tcfg, jp, tp, getattr(j_ssm, blk),
            getattr(t_ssm, blk), getattr(j_ssm, dec), getattr(t_ssm, dec),
            seqs)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("which", [0, 1])
def test_block_state_and_decode_match(block, which, fused):
    """The block with ``return_state`` (a padded last chunk), then 8
    decode steps from its state: outputs, state and conv taps."""
    kind, jcfg, tcfg, jp, tp, j_blk, t_blk, j_dec, t_dec, seqs = block
    s = seqs[which]
    x = _x((2, s, jcfg.d_model), s)
    run = lambda p, xx: j_blk(p, xx, jcfg, chunk=CHUNK, return_state=True)
    jo, jh, jc = (jax.jit(run) if fused else run)(
        jp, jnp.asarray(x, jnp.bfloat16))
    to, th, tc = t_blk(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg,
                       chunk=CHUNK, return_state=True, fused=fused)
    assert to.dtype == torch.bfloat16 and th.dtype == torch.float32
    assert tuple(to.shape) == jo.shape and tuple(th.shape) == jh.shape
    _close(to, jo, f"{kind} S={s} output")
    _close(th, jh, f"{kind} S={s} state", state=True)
    np.testing.assert_array_equal(_f32(tc), _f32(jc), f"{kind} conv tail")

    step = lambda p, xx, h, c: j_dec(p, xx, jcfg, h, c)
    step = jax.jit(step) if fused else step
    for t in range(N_DECODE):
        xt = _x((2, 1, jcfg.d_model), 100 + t)
        jo, jh, jc = step(jp, jnp.asarray(xt, jnp.bfloat16), jh, jc)
        h_in, c_in = th, tc
        to, th, tc = t_dec(tp, torch.from_numpy(xt).to(torch.bfloat16), tcfg,
                           th, tc, fused=fused)
        assert th is h_in and tc is c_in            # updated in place
        assert tuple(to.shape) == (2, 1, jcfg.d_model)
        _close(to, jo, f"{kind} decode step {t} output")
        _close(th, jh, f"{kind} decode step {t} state", state=True)
        np.testing.assert_array_equal(_f32(tc), _f32(jc),
                                      f"{kind} decode step {t} conv taps")


def test_deterministic_init_leaves():
    """The seeded init gives the reference's deterministic leaves:
    ``dt_b``, ``d_skip``, ``conv_b`` and ``norm_w`` bit for bit, with the
    reference's dtypes; ``a_log`` is ``log`` rounded once from float64,
    which XLA's float32 ``log`` on the CPU misses by an ulp at a few
    points (log 7 among them)."""
    gen = torch.Generator().manual_seed(0)
    for arch, init in (("falcon-mamba-7b", "init_mamba1"),
                       ("zamba2-2.7b", "init_mamba2")):
        for cfg_of in (lambda c: c.reduced(), lambda c: c):
            jcfg = cfg_of(j_configs.get_arch(arch))
            tcfg = cfg_of(t_configs.get_arch(arch))
            want = jax.eval_shape(
                lambda: getattr(j_ssm, init)(jax.random.PRNGKey(0), jcfg))
            names = ("dt_b", "d_skip", "conv_b", "a_log") + (
                ("norm_w",) if init == "init_mamba2" else ())
            shapes = (t_ssm.mamba1_shapes(tcfg) if init == "init_mamba1"
                      else t_ssm.mamba2_shapes(tcfg))
            ref = None
            if tcfg.d_model <= 256:              # reduced: build it whole
                ref = getattr(j_ssm, init)(jax.random.PRNGKey(0), jcfg)
            for name in names:
                shape, dtype = shapes[name]
                got = t_ssm.init_leaf(gen, name, shape, dtype, "cpu")
                assert tuple(got.shape) == want[name].shape, (arch, name)
                assert str(got.dtype).endswith(str(want[name].dtype)), name
                if ref is None:
                    continue
                exp = np.asarray(ref[name]).astype(np.float32)
                if name == "a_log":         # values <= log 16: ulp 2.4e-7
                    np.testing.assert_allclose(_f32(got), exp, rtol=0,
                                               atol=2.4e-7, err_msg=name)
                else:
                    np.testing.assert_array_equal(_f32(got), exp, name)
    # the random leaves at the reference's scales
    cfg = t_configs.get_arch("zamba2-2.7b").reduced()
    p = t_ssm.init_mamba2(torch.Generator().manual_seed(1), cfg)
    assert float(p["wdt"].float().std()) == pytest.approx(0.02, rel=0.2)
    assert float(p["conv_w"].float().std()) == pytest.approx(0.5, rel=0.2)
    assert float(p["wz"].float().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)


def test_mamba1_chunked_matches_sequential():
    """Mirror of tests/test_models.py: the chunked selective scan against
    the one-token decode recurrence (rtol 0.15, atol 0.15; the states to
    the Mamba-2 mirror's 0.05: the block rounds its conv output to bf16
    before the silu, the step does not), and the final state hands over
    to decode."""
    cfg = t_configs.get_arch("falcon-mamba-7b").reduced()
    p = t_ssm.init_mamba1(torch.Generator().manual_seed(0), cfg)
    b, s = 1, 12
    x = (torch.from_numpy(_x((b, s, cfg.d_model), 3)) * 0.3).to(torch.bfloat16)
    out, h_fin, tail = t_ssm.mamba1_block(p, x, cfg, chunk=4,
                                          return_state=True)
    di = t_ssm.d_inner(cfg)
    h = torch.zeros((b, di, cfg.ssm_state))
    conv = torch.zeros((b, cfg.ssm_conv - 1, di), dtype=torch.bfloat16)
    seq = torch.cat([t_ssm.mamba1_decode(p, x[:, t:t + 1], cfg, h, conv)[0]
                     for t in range(s)], dim=1)
    np.testing.assert_allclose(_f32(out), _f32(seq), rtol=0.15, atol=0.15)
    np.testing.assert_allclose(_f32(h_fin), _f32(h), rtol=0.05, atol=0.05)
    torch.testing.assert_close(tail, conv, rtol=0, atol=0)
    o_next, _, _ = t_ssm.mamba1_decode(p, x[:, -1:], cfg, h_fin, tail)
    assert o_next.shape == (b, 1, cfg.d_model)


def test_mamba2_chunked_matches_decode():
    """Mirror of tests/test_models.py: SSD chunked against its decode
    recurrence (outputs rtol/atol 0.2, states 0.05)."""
    cfg = t_configs.get_arch("zamba2-2.7b").reduced()
    p = t_ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    b, s = 1, 8
    x = (torch.from_numpy(_x((b, s, cfg.d_model), 4)) * 0.3).to(torch.bfloat16)
    out, h_fin, _ = t_ssm.mamba2_block(p, x, cfg, chunk=4, return_state=True)
    h = torch.zeros((b, t_ssm.m2_heads(cfg), cfg.ssm_head_dim,
                     cfg.ssm_state))
    conv = torch.zeros((b, cfg.ssm_conv - 1,
                        t_ssm.d_inner(cfg) + 2 * cfg.ssm_state),
                       dtype=torch.bfloat16)
    seq = torch.cat([t_ssm.mamba2_decode(p, x[:, t:t + 1], cfg, h, conv)[0]
                     for t in range(s)], dim=1)
    np.testing.assert_allclose(_f32(out), _f32(seq), rtol=0.2, atol=0.2)
    np.testing.assert_allclose(_f32(h_fin), _f32(h), rtol=0.05, atol=0.05)


def test_selective_scan_skips_padding_exactly():
    """The padded steps of a last partial chunk (dt = 0, x = 0) leave the
    state as it is, so the scan that skips them gives the padded run's
    final state bit for bit, and the same outputs at every real step."""
    rng = np.random.default_rng(7)
    b, s, di, n, chunk = 2, 10, 16, 4, 4
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, di)).astype(
        np.float32))
    xh, b_in, c_in = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in
        ((b, s, di), (b, s, n), (b, s, n)))
    a = -torch.exp(torch.from_numpy(rng.standard_normal((di, n)).astype(
        np.float32)))
    y, h = t_ssm._selective_scan(dt, xh, b_in, c_in, a, chunk)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 2))
    y_p, h_p = t_ssm._selective_scan(pad(dt), pad(xh), pad(b_in), pad(c_in),
                                     a, chunk)
    assert torch.equal(h, h_p)
    assert torch.equal(y, y_p[:, :s])


def test_masked_decay_stays_finite():
    """exp(cs_i - cs_j) overflows above the diagonal on a long chunk of
    large decays; the mask keeps it out (a product with 0 would be NaN)."""
    cfg = t_configs.get_arch("zamba2-2.7b").reduced()
    p = t_ssm.init_mamba2(torch.Generator().manual_seed(2), cfg)
    p["a_log"] = torch.full_like(p["a_log"], 6.0)    # a = -403 per step
    p["dt_b"] = torch.full_like(p["dt_b"], 3.0)
    x = torch.from_numpy(_x((1, 64, cfg.d_model), 5)).to(torch.bfloat16)
    out, h, _ = t_ssm.mamba2_block(p, x, cfg, chunk=64, return_state=True)
    assert torch.isfinite(out.float()).all() and torch.isfinite(h).all()
