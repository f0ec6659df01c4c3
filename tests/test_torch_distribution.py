"""The port's distribution layer against the reference's
(``tests/test_distribution.py``, mirrored): atomic checkpoints (round
trip, a partial publish ignored, ``keep_last``, restart equivalence, and
checkpoints crossing between the two packages in both directions),
elastic restore and batch splitting, int8 gradient compression (bit for
bit the reference's) and the compressed sum on a one-process gloo group,
and the straggler policy.

Bounds: checkpoints restore exactly; restart equivalence holds params to
the reference test's ``rtol=1e-5, atol=1e-6`` (the optimizer steps
exactly); quantization and the compressed sum are bit-equal to the
reference's.
"""
from __future__ import annotations

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # clean checkout: deterministic-cases fallback
    from _propcheck import given, settings, strategies as st

from repro.dist import checkpoint as j_ckpt
from repro.dist import compression as j_comp
from repro.dist import elastic as j_elastic
from repro.dist import straggler as j_straggler
from repro.train import optimizer as j_opt
from repro.train import step as j_step
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import checkpoint, compression, elastic, straggler
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.pytree import tree_map, tree_paths
from repro_torch.train import step as train_step_mod
from test_torch_train_grads import carry_state


def _tiny_state():
    cfg = configs.get_arch("yi-9b").reduced()
    return train_step_mod.init_state(0, cfg, device="cpu")


def _leaves(tree) -> list:
    return [(p, v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for p, v in tree_paths(tree)]


def _assert_same(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg="/".join(p))


# ---------------------------------------------------------------------------
# Checkpointing.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 7, state, process_index=0)
    step, restored = checkpoint.restore_latest(d, state)
    assert step == 7
    _assert_same(state, restored)
    assert restored["opt"]["step"].dtype == torch.int32
    # the files follow jax.tree.leaves order: dict keys sorted
    first = sorted(state)[0]
    assert first == "opt" and tree_paths(state)[0][0][:2] == ("opt", "m")
    assert len(os.listdir(os.path.join(d, "step_7"))) == \
        len(tree_paths(state)) + 1


def test_checkpoint_atomic_publish_ignores_partial(tmp_path):
    state = _tiny_state()
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, state, process_index=0)
    os.makedirs(os.path.join(d, "step_9.tmp"))
    os.makedirs(os.path.join(d, "step_5"))
    step, _ = checkpoint.restore_latest(d, state)
    assert step == 1
    checkpoint.save(d, 2, state, process_index=0)  # gc cleans the tmp
    assert not os.path.exists(os.path.join(d, "step_9.tmp"))


def test_checkpoint_keep_last(tmp_path):
    state = _tiny_state()
    d = str(tmp_path / "ckpt")
    for s in range(6):
        checkpoint.save(d, s, state, keep_last=3, process_index=0)
    assert checkpoint.published_steps(d) == [3, 4, 5]


def test_checkpoint_only_process_zero_writes(tmp_path):
    d = str(tmp_path / "ckpt")
    path = checkpoint.save(d, 3, _tiny_state(), process_index=1)
    assert path.endswith("step_3") and not os.path.exists(d)


def test_restore_rejects_a_mismatched_template(tmp_path):
    state = _tiny_state()
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, state, process_index=0)
    wrong_shape = tree_map(lambda a: a, state)
    wrong_shape["params"]["final_ln"] = torch.zeros(3)
    with pytest.raises(ValueError, match="final_ln"):
        checkpoint.restore(d, 1, wrong_shape)
    wrong_dtype = tree_map(lambda a: a, state)
    wrong_dtype["opt"]["step"] = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="step"):
        checkpoint.restore(d, 1, wrong_dtype)
    fewer = {"params": state["params"], "opt": {"step": state["opt"]["step"]}}
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(d, 1, fewer)


def test_checkpoint_restart_training_equivalence(tmp_path):
    """Kill-and-restart: 4 steps straight == 2, checkpoint, restore, 2
    more (the optimizer step exactly; params within rtol 1e-5/atol 1e-6)."""
    cfg = configs.get_arch("yi-9b").reduced()
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=2, seed=3)
    step_fn = train_step_mod.make_train_step(cfg)
    s_direct = train_step_mod.init_state(0, cfg, device="cpu")
    for i in range(4):
        s_direct, _ = step_fn(s_direct, pipeline.batch_at(dcfg, i))
    s_a = train_step_mod.init_state(0, cfg, device="cpu")
    for i in range(2):
        s_a, _ = step_fn(s_a, pipeline.batch_at(dcfg, i))
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 2, s_a, process_index=0)
    step, s_b = checkpoint.restore_latest(d, s_a)
    for i in range(step, 4):
        s_b, _ = step_fn(s_b, pipeline.batch_at(dcfg, i))
    assert int(s_direct["opt"]["step"]) == int(s_b["opt"]["step"]) == 4
    for (p, a), (_, b) in zip(tree_paths(s_direct["params"]),
                              tree_paths(s_b["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg="/".join(p))


def _stepped_reference(arch="zamba2-2.7b", **kw):
    """A reference train state after one jitted step (nonzero moments,
    step 1), and the port's template for it."""
    jcfg, tcfg, jst, tst = carry_state(arch, seed=2, **kw)
    dcfg = pipeline.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                               global_batch=2, seed=1)
    b = {k: jnp.asarray(v) for k, v in pipeline.batch_at(dcfg, 0).items()}
    jst, _ = jax.jit(j_step.make_train_step(jcfg, j_opt.OptConfig()))(jst, b)
    return tcfg, jst, tst


def test_reference_checkpoint_restores_in_port(tmp_path):
    tcfg, jst, template = _stepped_reference(n_layers=7)
    d = str(tmp_path / "ckpt")
    j_ckpt.save(d, 1, jst, process_index=0)
    step, restored = checkpoint.restore_latest(d, template, device="cpu")
    assert step == 1
    want = train_step_mod.state_from_numpy(jax.tree.map(np.asarray, jst),
                                           tcfg, device="cpu")
    _assert_same(want, restored)
    assert int(restored["opt"]["step"]) == 1


def test_port_checkpoint_restores_in_reference(tmp_path):
    tcfg, jst, _ = _stepped_reference(n_layers=7)
    port_state = train_step_mod.state_from_numpy(
        jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 5, port_state, process_index=0)
    step, restored = j_ckpt.restore_latest(d, jst)
    assert step == 5
    for (p, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, jst)),
                              tree_paths(jax.tree.map(np.asarray, restored))):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg="/".join(p))


def _bf16_state(seed: int = 0):
    """A tree with a bf16 leaf (serving parameters are bf16) beside
    float32 and int32 leaves, as numpy: the bf16 leaf's bits as int16."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    return {"params": {"w": np.asarray(jnp.asarray(w, jnp.bfloat16)),
                       "b": rng.standard_normal(7).astype(np.float32)},
            "step": np.asarray(3, np.int32)}


def _bf16_port(state):
    return {"params": {"w": torch.from_numpy(
                           state["params"]["w"].view(np.int16).copy()).view(
                               torch.bfloat16),
                       "b": torch.from_numpy(state["params"]["b"])},
            "step": torch.from_numpy(state["step"])}


def _bits(a) -> np.ndarray:
    """Raw bits of a bf16 leaf (tensor, ml_dtypes array or ``V2``)."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_leaf_restores_in_port(tmp_path, writer):
    """Queue item 15: a bf16 leaf saved by either package restores in the
    port as bf16, bit for bit; the file holds its raw 2-byte bits."""
    state = _bf16_state()
    template = _bf16_port(state)
    d = str(tmp_path / "ckpt")
    if writer == "port":
        checkpoint.save(d, 4, template, process_index=0)
    else:
        j_ckpt.save(d, 4, jax.tree.map(jnp.asarray, state), process_index=0)
    step, restored = checkpoint.restore_latest(d, template, device="cpu")
    assert step == 4
    w = restored["params"]["w"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (5, 7)
    np.testing.assert_array_equal(_bits(w), _bits(state["params"]["w"]))
    np.testing.assert_array_equal(restored["params"]["b"].numpy(),
                                  state["params"]["b"])
    assert int(restored["step"]) == 3
    # the leaf file: 2-byte void records holding the bf16 bits
    i = [p for p, _ in tree_paths(template)].index(("params", "w"))
    raw = np.load(os.path.join(d, "step_4", f"leaf_{i}.npy"))
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    np.testing.assert_array_equal(raw.view(np.int16),
                                  _bits(state["params"]["w"]))


def test_bf16_leaf_from_port_restores_in_reference(tmp_path):
    """The reference reads the port's bf16 leaf as the same 2-byte bits it
    writes itself."""
    state = _bf16_state(seed=1)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 2, _bf16_port(state), process_index=0)
    step, restored = j_ckpt.restore_latest(d, jax.tree.map(jnp.asarray, state))
    assert step == 2
    w = np.asarray(restored["params"]["w"])
    assert w.dtype.itemsize == 2 and w.shape == (5, 7)
    np.testing.assert_array_equal(_bits(w), _bits(state["params"]["w"]))
    np.testing.assert_array_equal(np.asarray(restored["params"]["b"]),
                                  state["params"]["b"])


def test_bf16_leaf_into_a_float_template_is_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    template = _bf16_port(_bf16_state())
    checkpoint.save(d, 1, template, process_index=0)
    template["params"]["w"] = template["params"]["w"].float()
    with pytest.raises(ValueError, match="params/w"):
        checkpoint.restore(d, 1, template)


# ---------------------------------------------------------------------------
# Elastic rescaling.
# ---------------------------------------------------------------------------

def test_elastic_reshard_roundtrip(tmp_path):
    state = _tiny_state()
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 3, state, process_index=0)
    step, restored = elastic.resume_elastic(d, state, make_host_mesh(1),
                                            run_dir=str(tmp_path))
    assert step == 3
    _assert_same(state, restored)
    log = os.path.join(str(tmp_path), "scale_events.jsonl")
    event = json.loads(open(log).read().splitlines()[-1])
    assert set(event) == {"time_unix", "step", "restored", "n_devices",
                          "mesh_axes"}
    assert event["restored"] and event["step"] == 3
    assert event["n_devices"] == 1
    assert event["mesh_axes"] == {"data": 1, "model": 1}


def test_elastic_resume_without_checkpoint(tmp_path):
    step, restored = elastic.resume_elastic(str(tmp_path / "none"),
                                            _tiny_state(), make_host_mesh(1))
    assert (step, restored) == (0, None)


@settings(max_examples=20, deadline=None)
@given(gb=st.integers(1, 4096), n=st.integers(1, 64))
def test_elastic_batch_invariants(gb, n):
    per, used = elastic.elastic_batch(gb, n)
    assert per >= 1
    assert used == per * n
    assert used <= max(gb, n)
    assert (per, used) == j_elastic.elastic_batch(gb, n)


# ---------------------------------------------------------------------------
# Gradient compression.
# ---------------------------------------------------------------------------

def _grad_cases():
    rng = np.random.default_rng(0)
    ties = np.zeros(256, np.float32)
    ties[0] = 127.0                        # scale 1: halves round to even
    ties[1:9] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.5, -125.5]
    return [rng.normal(size=(1000,)).astype(np.float32) * 3.0,
            rng.normal(size=(7, 33)).astype(np.float32),
            np.zeros((300,), np.float32),
            (rng.standard_cauchy(size=(4, 256)) * 1e3).astype(np.float32),
            ties]


@pytest.mark.parametrize("case", range(5))
def test_quantize_matches_reference_bitwise(case):
    g = _grad_cases()[case]
    jq, js, jpad = j_comp.quantize_int8(jnp.asarray(g))
    q, s, pad = compression.quantize_int8(torch.from_numpy(g))
    assert pad == jpad
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = compression.dequantize_int8(q, s, pad, g.shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_comp.dequantize_int8(jq, js, jpad,
                                                        g.shape)))


def test_quantize_roundtrip_error_bound(rng):
    g = torch.from_numpy((rng.normal(size=(1000,)) * 3.0).astype(np.float32))
    q, s, pad = compression.quantize_int8(g)
    back = compression.dequantize_int8(q, s, pad, g.shape)
    err = (back - g).abs().numpy()
    step = np.repeat(s.numpy(), compression.BLOCK)[: g.shape[0]]
    assert (err <= step * 0.5 + 1e-7).all()


@pytest.fixture
def gloo_group():
    dist = torch.distributed
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compressed_psum_error_feedback(rng, gloo_group):
    """Over repeated reductions error feedback keeps the accumulated
    estimate unbiased; each round's sum and residual bit-equal the
    reference's (its shard_map over one device)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    g = rng.normal(size=(512,)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fm = shard_map(lambda a, r: j_comp.compressed_psum_leaf(a, r, "data"),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    jr = jnp.zeros_like(jnp.asarray(g))
    r = torch.zeros(512)
    acc = torch.zeros(512)
    gt = torch.from_numpy(g)
    for _ in range(8):
        jout, jr = fm(jnp.asarray(g), jr)
        out, r = compression.compressed_psum_leaf(gt, r, gloo_group)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        acc = acc + out
    np.testing.assert_allclose(acc.numpy() / 8, g, atol=np.abs(g).max() / 100)
    # the checkpoint writer's rank comes from the group
    assert checkpoint._rank() == 0


def test_compressed_psum_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        compression.compressed_psum_leaf(torch.ones(4), torch.zeros(4))


# ---------------------------------------------------------------------------
# Straggler watchdog.
# ---------------------------------------------------------------------------

def test_straggler_policy_escalation():
    cfg = straggler.StragglerConfig(quantile=0.5, slack=2.0,
                                    escalate_after=3, min_history=4)
    w = straggler.StragglerWatchdog(cfg)
    for _ in range(8):
        assert w.observe(1.0) in (straggler.OK,)
    assert w.observe(10.0) == straggler.RETRY
    assert w.observe(10.0) == straggler.RETRY
    assert w.observe(10.0) == straggler.REJOIN
    assert w.observe(1.0) == straggler.OK
    assert w.observe(10.0) == straggler.RETRY


def test_straggler_single_gc_pause_tolerated():
    w = straggler.StragglerWatchdog(straggler.StragglerConfig(min_history=4))
    for _ in range(8):
        w.observe(1.0)
    assert w.observe(50.0) == straggler.RETRY
    for _ in range(4):
        assert w.observe(1.0) == straggler.OK


def test_straggler_matches_reference(rng):
    times = np.abs(rng.normal(1.0, 0.2, 400))
    times[rng.integers(0, 400, 40)] *= 8.0
    cfg = dict(quantile=0.7, slack=2.5, escalate_after=2, min_history=6,
               max_history=32)
    a = straggler.StragglerWatchdog(straggler.StragglerConfig(**cfg))
    b = j_straggler.StragglerWatchdog(j_straggler.StragglerConfig(**cfg))
    got = [a.observe(float(t)) for t in times]
    assert got == [b.observe(float(t)) for t in times]
    assert {straggler.OK, straggler.RETRY, straggler.REJOIN} <= set(got)
