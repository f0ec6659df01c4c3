"""The port's roofline (``repro_torch/roofline``) against the reference's.

Mirrors the roofline half of ``tests/test_optimizer_roofline.py`` (the
terms of ``analyze``, dense against MoE ``model_flops``, the FLOP count
of a matmul, of a 10-trip loop and of a checkpointed body), then holds
the port to the reference across packages: ``active_param_count`` for
all ten archs and ``model_flops`` for every cell of ``configs.all_cells``
exactly, and the FLOP count of reduced forwards and a reduced train step
(the reference's traced from abstract shapes, the port's counted while
its eager step runs on the CPU).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.roofline import analysis as j_analysis
from repro.roofline import jaxpr_cost as j_cost
from repro.train import optimizer as j_opt
from repro.train import step as j_step
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import ssm, transformer
from repro_torch.roofline import analysis, jaxpr_cost
from repro_torch.train import step as train_step

H100 = analysis.MACHINES["h100-sxm"]
B, S = 2, 64


# ---------------------------------------------------------------------------
# The machine profile.
# ---------------------------------------------------------------------------

def test_h100_profile():
    """NVIDIA's H100 SXM5 datasheet: dense bf16, HBM3, NVLink 4 per link
    and direction; the host profile is the reference's; no TPU profile."""
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == \
        (989e12, 3.35e12, 25e9)
    cpu, ref_cpu = (analysis.MACHINES["cpu-interpret"],
                    j_analysis.MACHINES["cpu-interpret"])
    assert (cpu.peak_flops, cpu.hbm_bw, cpu.link_bw) == \
        (ref_cpu.peak_flops, ref_cpu.hbm_bw, ref_cpu.ici_bw)
    assert sorted(analysis.MACHINES) == ["cpu-interpret", "h100-sxm"]


@pytest.mark.parametrize("card,want", [
    (None, "cpu-interpret"),
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 PCIe", RuntimeError),
    ("NVIDIA A100-SXM4-80GB", RuntimeError),
])
def test_current_machine(monkeypatch, card, want):
    monkeypatch.delenv(analysis.MACHINE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card is not None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: card)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match=analysis.MACHINE_ENV):
            analysis.current_machine()
    else:
        assert analysis.current_machine().name == want
    # the env knob wins over the card, and an unknown name raises
    monkeypatch.setenv(analysis.MACHINE_ENV, "h100-sxm")
    assert analysis.current_machine() is H100
    monkeypatch.setenv(analysis.MACHINE_ENV, "v5e")
    with pytest.raises(ValueError, match="not a known machine profile"):
        analysis.current_machine()


# ---------------------------------------------------------------------------
# analyze and model_flops.
# ---------------------------------------------------------------------------

def test_roofline_analyze_terms():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 * 2}
    coll = {"total": 25e9 * 0.5}
    r = analysis.analyze(cost, coll, model_flops_per_device=100e12,
                         machine=H100)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.useful_ratio == pytest.approx(100e12 / 989e12)


@pytest.mark.parametrize("counted", [None, 3e12])
def test_analyze_matches_reference(counted):
    """The same cost, collective bytes and rates give the reference's
    terms field for field, with and without a counted step's FLOPs."""
    cost = {"flops": 1e12, "bytes accessed": 4e10}
    coll = {"total": 2e9}
    ref_h100 = j_analysis.Machine("h100-sxm", H100.peak_flops, H100.hbm_bw,
                                  H100.link_bw)
    got = analysis.analyze(cost, coll, model_flops_per_device=5e11,
                           jaxpr_flops_per_device=counted, machine=H100)
    want = j_analysis.analyze(cost, coll, model_flops_per_device=5e11,
                              jaxpr_flops_per_device=counted,
                              machine=ref_h100)
    assert got.as_dict() == want.as_dict()


def test_model_flops_dense_vs_moe():
    dense = configs.get_arch("yi-9b")
    moe = configs.get_arch("qwen3-moe-30b-a3b")
    shape = configs.get_shape("train_4k")
    fd = analysis.model_flops(dense, shape, 256)
    fm = analysis.model_flops(moe, shape, 256)
    n_active = analysis.active_param_count(moe)
    n_total_experts = (moe.n_experts * moe.moe_d_ff * moe.d_model
                       * 3 * moe.n_layers)
    # active fraction: top-8 of 128 experts
    assert n_active < n_total_experts
    assert fd > 0 and fm > 0


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_count_and_model_flops_match_reference(arch):
    """Exact for every arch and every (arch, shape) cell."""
    cfg = configs.get_arch(arch)
    jcfg = j_configs.get_arch(arch)
    assert analysis.active_param_count(cfg) == \
        j_analysis.active_param_count(jcfg)
    cells = [(s, js) for (a, s, _, _), (_, js, _, _) in
             zip(configs.all_cells(), j_configs.all_cells())
             if a.name == arch]
    assert len(cells) == len(configs.SHAPES)
    for shape, jshape in cells:
        assert shape.name == jshape.name
        for n_dev in (1, 256):
            assert analysis.model_flops(cfg, shape, n_dev) == \
                j_analysis.model_flops(jcfg, jshape, n_dev), shape.name


# ---------------------------------------------------------------------------
# step_flops: counted while the eager step runs.
# ---------------------------------------------------------------------------

def test_step_flops_matmul_exact():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    assert jaxpr_cost.step_flops(lambda x, y: x @ y, a, b) == 2 * 64 * 32 * 16


def test_step_flops_counts_every_loop_trip():
    """The reference multiplies a scan's body by its length; eager code
    runs all 10 trips, and each is counted."""
    def f(x):
        c = x
        for _ in range(10):
            c = c @ x
        return c
    assert jaxpr_cost.step_flops(f, torch.ones(16, 16)) == 10 * 2 * 16 ** 3
    xs = jax.ShapeDtypeStruct((16, 16), jnp.float32)
    assert j_cost.step_flops(
        lambda x: jax.lax.scan(lambda c, _: (c @ x, None), x, None,
                               length=10)[0], xs) == 10 * 2 * 16 ** 3


def test_step_flops_counts_the_checkpoint_recompute():
    """Forward only, a checkpointed body counts once, as the reference's
    remat does.  With the backward pass, its recompute counts as far as it
    runs: a non-reentrant checkpoint stops recomputing once the backward
    has every tensor it saved, so the body's last product is not rerun."""
    def g(y):
        return torch.tanh(y @ y) @ y

    mm = 2 * 8 ** 3
    assert jaxpr_cost.step_flops(
        lambda: torch.utils.checkpoint.checkpoint(g, torch.ones(8, 8),
                                                  use_reentrant=False)
    ) == 2 * mm

    def step(remat: bool):
        y = torch.ones(8, 8, requires_grad=True)
        out = (torch.utils.checkpoint.checkpoint(g, y, use_reentrant=False)
               if remat else g(y))
        out.sum().backward()

    # two forward products, two gradient products for each
    assert jaxpr_cost.step_flops(step, False) == 6 * mm
    # ... and the recompute of y @ y, which tanh's saved output needs
    assert jaxpr_cost.step_flops(step, True) == 7 * mm


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, vocab, (B, S)).astype(
        np.int32)


def _forward_flops(arch: str) -> tuple[float, float]:
    """(port, reference) FLOPs of one reduced forward over B x S tokens."""
    cfg, jcfg = configs.get_arch(arch).reduced(), \
        j_configs.get_arch(arch).reduced()
    params = transformer.init_params(cfg, seed=0, device="cpu")
    toks = _tokens(cfg.vocab_size)
    with torch.no_grad():
        got = jaxpr_cost.step_flops(
            lambda: transformer.forward(params, cfg, {"tokens": toks}))
    jparams = jax.eval_shape(
        lambda: j_tf.init_params(jax.random.PRNGKey(0), jcfg))
    want = j_cost.step_flops(
        lambda p, t: j_tf.forward(p, jcfg, {"tokens": t}), jparams,
        jax.ShapeDtypeStruct((B, S), jnp.int32))
    return got, want


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-27b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b"])
def test_forward_flops_match_reference(arch):
    got, want = _forward_flops(arch)
    assert got == want


def test_zamba2_forward_flops_short_by_the_outer_products():
    """zamba2's count is 262,144 FLOPs (0.12%) short; held within 0.2%.

    The gap is exactly the outer products inside Mamba-2's two
    three-operand einsums (``"bln,bhpn,blh->blhp"`` and
    ``"blh,bln,blhp->bhpn"``): JAX contracts the ``blh`` and ``bln``
    operands first, as a ``dot_general`` with nothing contracted, which
    the reference counts at 2 FLOPs a product; ``torch.einsum`` makes
    that step a broadcast multiply, which the counter does not count.
    """
    got, want = _forward_flops("zamba2-2.7b")
    cfg = configs.get_arch("zamba2-2.7b").reduced()
    n_mamba2 = cfg.layer_pattern().count("mamba2")
    # (b, l, h) x (b, l, n) per einsum, two einsums per Mamba-2 block
    outer = 2 * B * S * ssm.m2_heads(cfg) * cfg.ssm_state
    assert want - got == n_mamba2 * 2 * outer == 262_144
    assert abs(got / want - 1) < 2e-3


def test_train_step_flops_near_reference():
    """One reduced zamba2 train step within 2.5% of the reference's count
    (0.980 today).  The port counts less recompute: its remat covers each
    layer group but not the reference's inner remats around attention
    and each SSM chunk, and its non-reentrant recompute stops once the
    backward has what it saved."""
    cfg, jcfg = configs.get_arch("zamba2-2.7b").reduced(), \
        j_configs.get_arch("zamba2-2.7b").reduced()
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1), 0)
    state = train_step.init_state(0, cfg, device="cpu")
    got = jaxpr_cost.step_flops(train_step.make_train_step(cfg), state, batch)
    jstate = jax.eval_shape(
        lambda: j_step.init_state(jax.random.PRNGKey(0), jcfg))
    jbatch = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
              for k, v in batch.items()}
    want = j_cost.step_flops(j_step.make_train_step(jcfg, j_opt.OptConfig()),
                             jstate, jbatch)
    assert 0.975 <= got / want <= 1.0


def test_collective_bytes_counts_output_bytes():
    """``analysis.collective_bytes``, the counterpart of the reference's
    HLO reader: the OUTPUT bytes of each collective a function issues, by
    the reference's kinds, raw ``torch.distributed`` calls and functional
    ones alike (a gloo world of one process); ``barrier`` moves nothing
    and a broadcast counts as ``collective-permute``."""
    import socket

    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        x, out = torch.ones(4, 8), torch.empty(4, 8)

        def step():
            dist.all_reduce(x)
            dist.all_gather_into_tensor(out, x)
            dist.broadcast(x, 0)
            dist.barrier()
            funcol.wait_tensor(funcol.all_reduce(x.clone(), "sum",
                                                 dist.group.WORLD))

        got = analysis.collective_bytes(step)
    finally:
        dist.destroy_process_group()
    assert got == {"all-gather": 128, "all-reduce": 256,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 128, "total": 512}
