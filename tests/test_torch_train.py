"""Parity of the port's training stack with the reference: the data
pipeline's token stream, the optimizer (schedule, global norm, clipping,
the decay mask and the AdamW update), the train step with and without
microbatches, a 4-step loss trajectory, the launcher and the example.

Bounds, stated where they are used:

* ``batch_at`` bit for bit (the port pins numpy 2.0's zipf sampler; this
  runs on numpy 2.0, where the reference draws the same);
* the optimizer on identical inputs within ``OPT_RTOL = 1e-6`` of each
  leaf's largest magnitude (float32 arithmetic in the reference's order;
  the two packages' ``cos``, ``pow`` and reductions may differ in the
  last place, and the global norm's order moves the clip scale by an
  ulp);
* one train step against the reference's jitted step: the loss within
  ``1e-3`` relative, the gradient norm within ``2e-2``, the first moment
  ``m`` leaf by leaf within ``GRAD_RTOL`` relative L2 and ``v`` within
  twice it (the gradients' own bound, ``tests/test_torch_train_grads.py``),
  and each param within the most one update can move it,
  ``2 * lr * (1 + wd * |p|)``;
* the 4-step trajectory at ``peak_lr = 1e-2``: losses within
  ``TRAJ_RTOL = 1e-2`` and gradient norms within ``2e-2`` relative
  (measured 2.2e-3 and 8.6e-3: Adam's first steps are ``lr * sign(g)``,
  so an element whose gradient is near zero moves by a whole ``lr`` in
  one package and not the other).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipeline
from repro.train import optimizer as j_opt
from repro.train import step as j_step
from repro_torch.data import pipeline as t_pipeline
from repro_torch.launch import train as t_launch
from repro_torch.pytree import tree_map, tree_paths
from repro_torch.train import optimizer as t_opt
from repro_torch.train import step as t_step
from test_torch_train_grads import GRAD_RTOL, carry_state

ROOT = Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
TRAJ_RTOL = 1e-2


def _np(tree):
    return {"/".join(p): np.asarray(v) for p, v in
            tree_paths(jax.tree.map(np.asarray, tree))}


def _tnp(tree):
    return {"/".join(p): v.detach().numpy().copy()
            for p, v in tree_paths(tree)}


def _close_trees(want: dict, got: dict, rtol: float, what: str) -> None:
    """Leaf by leaf, ``max |got - want| <= rtol * max |want|``: relative
    to the leaf's scale, since a moment whose two terms cancel (``b1 * m``
    against ``(1 - b1) * g``) keeps no relative precision of its own."""
    assert sorted(want) == sorted(got), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        err = np.abs(got[k] - want[k]).max(initial=0)
        assert err <= rtol * np.abs(want[k]).max(initial=0), (what, k, err)


# ---------------------------------------------------------------------------
# Data pipeline.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step,shard,n_shards", [
    (1000, 32, 8, 0, 5, 0, 1), (512, 16, 4, 3, 0, 1, 2),
    (32000, 256, 4, 0, 59, 0, 1), (8192, 64, 2, 7, 123456, 3, 4),
    (65024, 512, 2, 0, 2, 0, 1)])
def test_batch_at_matches_reference(vocab, seq, batch, seed, step, shard,
                                    n_shards):
    want = j_pipeline.batch_at(j_pipeline.DataConfig(vocab, seq, batch, seed),
                               step, shard, n_shards)
    got = t_pipeline.batch_at(t_pipeline.DataConfig(vocab, seq, batch, seed),
                              step, shard, n_shards)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_batch_at_deterministic_and_shardable():
    cfg = t_pipeline.DataConfig(vocab_size=1000, seq_len=32, global_batch=8)
    a = t_pipeline.batch_at(cfg, step=5)
    np.testing.assert_array_equal(a["tokens"],
                                  t_pipeline.batch_at(cfg, step=5)["tokens"])
    assert (a["tokens"] != t_pipeline.batch_at(cfg, step=6)["tokens"]).any()
    s0 = t_pipeline.batch_at(cfg, 5, shard=0, n_shards=4)
    np.testing.assert_array_equal(
        s0["tokens"], t_pipeline.batch_at(cfg, 5, shard=0, n_shards=4)["tokens"])
    s1 = t_pipeline.batch_at(cfg, 5, shard=1, n_shards=4)
    assert s0["tokens"].shape == (2, 32)
    assert (s0["tokens"] != s1["tokens"]).any()
    assert a["tokens"].min() >= 1 and a["tokens"].max() < 1000
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# Optimizer against the reference, on identical inputs.
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    for jc, tc in [(j_opt.OptConfig(), t_opt.OptConfig()),
                   (j_opt.OptConfig(peak_lr=1e-3, warmup_steps=10,
                                    total_steps=100, min_lr_ratio=0.1),
                    t_opt.OptConfig(peak_lr=1e-3, warmup_steps=10,
                                    total_steps=100, min_lr_ratio=0.1)),
                   (j_opt.OptConfig(warmup_steps=0, total_steps=50),
                    t_opt.OptConfig(warmup_steps=0, total_steps=50))]:
        steps = np.arange(0, jc.total_steps + 40, 3, dtype=np.int32)
        want = np.asarray(j_opt.schedule(jc, jnp.asarray(steps)))
        got = t_opt.schedule(tc, torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=0)


def _tree(rng, scale=1.0):
    """A nested tree whose insertion order is not sorted, with leaves the
    decay mask keys on (1-D and stacked norms, SSM leaves)."""
    r = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"groups": {"b1": {"ln1": r(3, 8), "ssm": {"d_skip": r(3, 16),
                                                      "wz": r(3, 8, 16),
                                                      "a_log": r(3, 16, 4)}},
                       "b0": {"attn": {"wq": r(3, 8, 8)}, "ln1": r(3, 8)}},
            "final_ln": r(8), "embed": {"embed": r(32, 8)},
            "rem0": {"ssm": {"conv_b": r(16), "dt_b": r(4)}, "ln1": r(8)}}


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(0)
    for scale in (0.01, 3.0):
        t = _tree(rng, scale)
        want_n = float(j_opt.global_norm(jax.tree.map(jnp.asarray, t)))
        got_n = float(t_opt.global_norm(tree_map(torch.from_numpy, t)))
        assert got_n == pytest.approx(want_n, rel=OPT_RTOL)
        jc, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, t), 1.0)
        tc, tn = t_opt.clip_by_global_norm(tree_map(torch.from_numpy, t), 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=OPT_RTOL)
        _close_trees(_np(jc), _tnp(tc), OPT_RTOL, "clipped")


def test_adamw_update_matches_reference():
    """Three steps on identical params and gradients: params, m, v, the
    step, lr and grad norm, leaf by leaf (decayed and undecayed leaves,
    stacked and 1-D, clipping on and off)."""
    rng = np.random.default_rng(1)
    params = _tree(rng, 0.5)
    jc = j_opt.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    tc = t_opt.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init_opt_state(jp)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = t_opt.init_opt_state(tp)
    for i, scale in enumerate((5.0, 0.01, 2.0)):
        g = _tree(rng, scale)
        jp, js, jm = j_opt.adamw_update(jc, jp, js,
                                        jax.tree.map(jnp.asarray, g))
        tg = tree_map(torch.from_numpy, g)
        before = _tnp(tg)
        tp, ts, tm = t_opt.adamw_update(tc, tp, ts, tg)
        _close_trees(before, _tnp(tg), 0, "gradients left unchanged")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=OPT_RTOL)
        _close_trees(_np(jp), _tnp(tp), OPT_RTOL, f"step {i} params")
        _close_trees(_np(js["m"]), _tnp(ts["m"]), OPT_RTOL, f"step {i} m")
        _close_trees(_np(js["v"]), _tnp(ts["v"]), OPT_RTOL, f"step {i} v")


# The reference's optimizer tests (tests/test_optimizer_roofline.py),
# mirrored.

def test_adamw_converges_on_quadratic():
    cfg = t_opt.OptConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2))}
    state = t_opt.init_opt_state(params)
    for _ in range(150):
        grads = {"w": params["w"] - target}
        params, state, metrics = t_opt.adamw_update(cfg, params, state, grads)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)
    assert float(metrics["grad_norm"]) < 1.0


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0)}
    clipped, gn = t_opt.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(10 * 100.0 ** 2), rel=1e-5)
    assert float(t_opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)
    c2, _ = t_opt.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    np.testing.assert_allclose(c2["a"].numpy(), 0.1, rtol=1e-6)


def test_lr_schedule_shape():
    cfg = t_opt.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(t_opt.schedule(cfg, s)) for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1e-3, rel=1e-5)
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-2)
    assert all(b <= a * 1.0001 for a, b in zip(lrs[2:], lrs[3:]))


def test_no_weight_decay_on_norms():
    cfg = t_opt.OptConfig(peak_lr=0.0, weight_decay=1.0)
    params = {"ln1": torch.ones((4,)), "wq": torch.ones((4, 4))}
    state = t_opt.init_opt_state(params)
    zero_g = tree_map(torch.zeros_like, params)
    new, _, _ = t_opt.adamw_update(cfg, params, state, zero_g)
    np.testing.assert_array_equal(new["ln1"].numpy(), 1.0)


@pytest.mark.parametrize("arch,n_layers", [("zamba2-2.7b", 7),
                                           ("falcon-mamba-7b", None)])
def test_decay_mask_matches_reference(arch, n_layers):
    """With zero gradients an update is pure weight decay, so the leaves
    it moves are the decayed ones: leaf by leaf the same set as the
    reference's (a stacked per-head leaf such as Mamba-2's ``a_log`` (G,
    H) decays, its remainder twin (H,) does not), and the same values."""
    kw = {"n_layers": n_layers} if n_layers else {}
    jcfg, tcfg, jst, tst = carry_state(arch, seed=0, **kw)
    jc = j_opt.OptConfig(peak_lr=0.5, warmup_steps=1, weight_decay=1.0)
    tc = t_opt.OptConfig(peak_lr=0.5, warmup_steps=1, weight_decay=1.0)
    before = _tnp(tst["params"])
    jp, _, _ = jax.jit(lambda p, o, g: j_opt.adamw_update(jc, p, o, g))(
        jst["params"], jst["opt"],
        jax.tree.map(jnp.zeros_like, jst["params"]))
    tp, _, _ = t_opt.adamw_update(
        tc, tst["params"], tst["opt"],
        tree_map(torch.zeros_like, tst["params"]))
    want, got = _np(jp), _tnp(tp)
    moved_ref = {k for k in want if not np.array_equal(want[k], before[k])}
    moved = {k for k in got if not np.array_equal(got[k], before[k])}
    assert moved == moved_ref
    if n_layers:
        # Mamba-2's a_log: (G, H) stacked decays, (H,) in the remainder not;
        # d_skip is excluded by name in both
        assert "groups/b0/ssm/a_log" in moved
        assert "rem0/ssm/a_log" not in moved and "rem0/ln1" not in moved
        assert "groups/b0/ssm/d_skip" not in moved
    _close_trees(want, got, OPT_RTOL, "decayed params")


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------

def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    jcfg, tcfg, jst, tst = carry_state("yi-9b", seed=0)
    p0 = _tnp(tst["params"])
    jo, to = j_opt.OptConfig(), t_opt.OptConfig()
    batch = t_pipeline.batch_at(t_pipeline.DataConfig(tcfg.vocab_size, 32,
                                                      4, 5), 0)
    jst, jm = jax.jit(j_step.make_train_step(jcfg, jo, microbatches))(
        jst, _ref_batch(batch))
    tst, tm = t_step.make_train_step(tcfg, to, microbatches)(tst, batch)
    assert set(tm) == {"loss", "lr", "grad_norm"}
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=2e-2)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=OPT_RTOL)
    assert int(tst["opt"]["step"]) == 1
    lr = float(jm["lr"])
    for name, bound in (("m", GRAD_RTOL), ("v", 2 * GRAD_RTOL)):
        want, got = _np(jst["opt"][name]), _tnp(tst["opt"][name])
        for k in want:
            err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            assert err <= bound, (name, k, err)
    want, got = _np(jst["params"]), _tnp(tst["params"])
    for k in want:
        reach = 2 * lr * (1 + jo.weight_decay * np.abs(p0[k])) + 1e-7
        assert (np.abs(got[k] - want[k]) <= reach).all(), k


def test_microbatches_split_rows_in_order():
    """Two microbatches give the mean of the two halves' losses and
    gradients, added first half first."""
    _, tcfg, _, tst = carry_state("yi-9b", seed=0)
    batch = t_pipeline.batch_at(t_pipeline.DataConfig(tcfg.vocab_size, 16,
                                                      4, 2), 0)
    loss, grads = t_step.loss_and_grads(tcfg, tst["params"], batch, 2)
    halves = [t_step.loss_and_grads(
        tcfg, tst["params"], {k: v[i:i + 2] for k, v in batch.items()})
        for i in (0, 2)]
    assert float(loss) == float((halves[0][0] + halves[1][0]) / 2)
    for (p, g), (_, a), (_, b) in zip(tree_paths(grads),
                                      tree_paths(halves[0][1]),
                                      tree_paths(halves[1][1])):
        assert torch.equal(g, (a + b) / 2), p


def test_loss_trajectory_matches_reference():
    jcfg, tcfg, jst, tst = carry_state("yi-9b", seed=0)
    jo = j_opt.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=100)
    to = t_opt.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=100)
    jf = jax.jit(j_step.make_train_step(jcfg, jo))
    tf = t_step.make_train_step(tcfg, to)
    dcfg = t_pipeline.DataConfig(tcfg.vocab_size, 32, 4, 5)
    losses = []
    for i in range(4):
        b = t_pipeline.batch_at(dcfg, i)
        jst, jm = jf(jst, _ref_batch(b))
        tst, tm = tf(tst, b)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=TRAJ_RTOL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=2e-2)
        losses.append(float(tm["loss"]))
    assert int(tst["opt"]["step"]) == 4
    assert losses[-1] < losses[0]


def test_state_from_numpy_checks_the_tree():
    jcfg, tcfg, jst, _ = carry_state("yi-9b", seed=0)
    tree = jax.tree.map(np.asarray, jst)
    bad = jax.tree.map(lambda a: a, tree)
    bad["params"]["final_ln"] = bad["params"]["final_ln"].astype(np.float16)
    with pytest.raises(ValueError, match="final_ln"):
        t_step.state_from_numpy(bad, tcfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["opt"]["step"] = np.int64(0)
    with pytest.raises(ValueError, match="step"):
        t_step.state_from_numpy(bad, tcfg, device="cpu")
    st = t_step.state_from_numpy(tree, tcfg, device="cpu")
    assert all(v.dtype == torch.float32 for _, v in tree_paths(st["params"]))
    assert st["opt"]["step"].dtype == torch.int32


def test_cast_bf16_follows_the_ndim_rule():
    _, tcfg, _, tst = carry_state("zamba2-2.7b", seed=0, n_layers=7)
    cast = dict(tree_paths(t_step.cast_bf16(tst["params"])))
    for path, p in tree_paths(tst["params"]):
        want = torch.bfloat16 if p.dim() >= 2 else torch.float32
        assert cast[path].dtype == want, path
    assert cast[("groups", "b0", "ssm", "d_skip")].dtype == torch.bfloat16
    assert cast[("rem0", "ssm", "d_skip")].dtype == torch.float32


# ---------------------------------------------------------------------------
# Entry points: the launcher and the example.
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch import configs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_arch("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_step.init_state(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--reduced", "--steps", "1"])


def test_launch_seq_shard_attn_on_one_process():
    """tests/test_examples_and_opts.py::test_seq_shard_train_step_still_
    correct through the launcher: on a world of one (no mesh to shard
    over) ``--seq-shard-attn`` gives the loss without it."""
    argv = ["--reduced", "--device", "cpu", "--steps", "1", "--batch", "2",
            "--seq", "32"]
    _, plain = t_launch.main(argv)
    _, sharded = t_launch.main(argv + ["--seq-shard-attn"])
    np.testing.assert_allclose(sharded[0]["loss"], plain[0]["loss"],
                               rtol=1e-5)


def test_launch_train_runs_and_restores(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt,
            "--ckpt-every", "2"]
    state, history = t_launch.main(argv + ["--steps", "4"])
    assert [h["step"] for h in history] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in history)
    assert int(state["opt"]["step"]) == 4
    state2, history2 = t_launch.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "elastic restore at step 4 onto 1 device" in out
    assert "[launch] done" in out
    assert [h["step"] for h in history2] == [4, 5]
    assert int(state2["opt"]["step"]) == 6
    events = [json.loads(line) for line in
              open(os.path.join(ckpt, "scale_events.jsonl"))]
    assert [e["restored"] for e in events] == [False, True]
    assert events[1]["step"] == 4 and events[1]["n_devices"] == 1
    assert events[1]["mesh_axes"] == {"data": 1, "model": 1}


def _run_example(*args):
    r = subprocess.run([sys.executable, "examples/train_lm_torch.py", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_train_lm_torch_example_loss_down_and_restart(tmp_path):
    """tests/test_examples_and_opts.py::test_train_lm_example_loss_down
    on the port, then a rerun to a later step restores the checkpoint."""
    args = ["--device", "cpu", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    out = _run_example(*args, "--steps", "6")
    assert "DOWN" in out
    assert "published" in out
    out = _run_example(*args, "--steps", "8")
    assert "restored checkpoint at step 6" in out
    assert "step    7" in out
