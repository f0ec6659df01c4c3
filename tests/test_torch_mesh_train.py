"""The port's training over a (2, 2) ("data", "model") mesh of four gloo
processes on the CPU, held to the reference's GSPMD step over four forced
host devices.

One module fixture starts, together, the reference in a subprocess
(``tests/_ref_train_mesh_dump.py`` under
``--xla_force_host_platform_device_count=4``) and the port's four ranks
(``tests/_torch_mesh_ranks.py``, one process per mesh position, from the
reference's initial states as numpy); each writes its results to files,
and each check below reads them.  Outputs are compared as full values,
not by layout: the reference's launcher leaves its out-shardings to XLA.

Bounds, stated where they are used:

* placement bit for bit: every rank's block of every state leaf is the
  reference's shard on the device at the same mesh position;
* one step (yi-9b with and without ``attn_seq_shard``, at microbatches 1
  and 2, and zamba2-2.7b; all reduced; 4 x 32 tokens a microbatch):
  those of
  ``test_torch_train.py::test_make_train_step_matches_reference`` — the
  loss within 1e-3 relative, the gradient norm within 2e-2, ``lr``
  within 1e-6, the moments within ``GRAD_RTOL`` relative L2 (``v``
  twice it), each param within ``2 * lr * (1 + wd * |p0|) + 1e-7`` —
  against the reference's mesh step and against the port's one-process
  step;
* the int8-compressed sum over four processes: every residual bit for
  bit, each round's sum within 1e-6 of the reference sum's max |value|
  (the two sums add in other orders), the 8-round mean within 1% of the
  largest exact sum (error feedback keeps it unbiased);
* checkpoints bit for bit both ways between four ranks and one process,
  and readable by the reference;
* no functional all-gather in any case's step on any rank
  (``roofline.analysis.NoFunctionalGather``, recording);
* the collectives of the ``yi`` step that the dry run counts on a fake
  (2, 2) world (rank 0 of four, ``meta`` blocks) equal those rank 0 of
  the four processes issued, kind by kind and byte for byte.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _ref_train_mesh_dump as ref
from _torch_mesh_ranks import tree_of
from repro.dist import checkpoint as j_ckpt
from repro.train import step as j_step
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import checkpoint
from repro_torch.pytree import tree_paths
from repro_torch.train import optimizer as t_opt
from repro_torch.train import step as t_step
from test_torch_train_grads import GRAD_RTOL

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 300


def _port_cfg(arch, seq_shard=False):
    import dataclasses
    cfg = configs.get_arch(arch).reduced()
    if seq_shard:
        cfg = dataclasses.replace(cfg, attn_seq_shard=("data",))
    return cfg


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the reference and the four ranks together; their files."""
    work = tmp_path_factory.mktemp("mesh_train")
    init = {}
    for arch in ref.ARCHS:
        st = j_step.init_state(jax.random.PRNGKey(0), ref.arch_cfg(arch))
        init.update({f"{arch}/{p}": np.asarray(v)
                     for p, v in ref.leaf_paths(st)})
    np.savez(work / "init.npz", **init)
    checkpoint.save(str(work / "ckpt_one"), 1, t_step.state_from_numpy(
        tree_of(init, "yi-9b"), _port_cfg("yi-9b"), device="cpu"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    cmds = [([sys.executable, str(ROOT / "tests" / "_ref_train_mesh_dump.py"),
              str(work / "ref.npz")],
             dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))]
    port = _free_port()
    cmds += [([sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"),
               str(r), str(port), str(work)], env) for r in range(WORLD)]
    procs = []
    for i, (cmd, e) in enumerate(cmds):
        with open(work / f"log{i}.txt", "w") as log:
            procs.append(subprocess.Popen(cmd, env=e, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, (work / f"log{i}.txt").read_text()[-4000:]
    return SimpleNamespace(
        work=work, init=init, ref=dict(np.load(work / "ref.npz")),
        ranks=[dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)])


def _under(d: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in d.items() if k.startswith(prefix + "/")}


def test_one_device_init_is_the_mesh_init(run):
    """The ranks start from the reference's ``init_state`` drawn here on
    one device: the same bits as on its four-device mesh."""
    for arch in ref.ARCHS:
        want, got = _under(run.ref, f"{arch}/init"), _under(run.init, arch)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ref.ARCHS)
def test_placement_is_the_reference_shard(run, arch):
    """``sharding.place`` by ``state_specs``: every rank's block of every
    leaf equals the reference's shard at its mesh position, bit for bit
    (yi-9b's attention and MLP weights and the vocabulary split over
    ``model``; zamba2's SSM projections too)."""
    split = 0
    for r in range(WORLD):
        want = _under(run.ref, f"{arch}/shard{r}")
        got = _under(run.ranks[r], f"{arch}/block")
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=(r, k))
            split += got[k].shape != run.init[f"{arch}/{k}"].shape
    assert split > 0


def _held(want_m: dict, got_m: dict, want: dict, got: dict, p0: dict):
    """The bounds of ``test_make_train_step_matches_reference``."""
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=1e-3)
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=2e-2)
    assert float(got_m["lr"]) == pytest.approx(float(want_m["lr"]), rel=1e-6)
    assert int(got["opt/step"]) == int(want["opt/step"]) == 1
    for name, bound in (("m", GRAD_RTOL), ("v", 2 * GRAD_RTOL)):
        for k in (k for k in want if k.startswith(f"opt/{name}/")):
            err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            assert err <= bound, (k, err)
    lr, wd = float(want_m["lr"]), t_opt.OptConfig().weight_decay
    for k in (k for k in want if k.startswith("params/")):
        reach = 2 * lr * (1 + wd * np.abs(p0[k[len("params/"):]])) + 1e-7
        assert (np.abs(got[k] - want[k]) <= reach).all(), k


@pytest.mark.parametrize("case", list(ref.CASES))
def test_mesh_step_matches_reference(run, case):
    """One step on the (2, 2) mesh against the reference's jitted step
    on its four-device mesh."""
    arch = ref.CASES[case][0]
    _held(_under(run.ref, f"{case}/metric"),
          _under(run.ranks[0], f"{case}/metric"),
          _under(run.ref, f"{case}/after"),
          _under(run.ranks[0], f"{case}/after"),
          _under(run.init, f"{arch}/params"))


@pytest.mark.parametrize("case", list(ref.CASES))
def test_mesh_step_matches_one_process(run, case):
    """The same step against the port's step in one process (plain
    tensors) from the same state and batch."""
    arch, seq_shard, mb = ref.CASES[case]
    cfg = _port_cfg(arch, seq_shard)
    st = t_step.state_from_numpy(tree_of(run.init, arch), cfg, device="cpu")
    batch = ref.case_batch(pipeline, case, cfg.vocab_size)
    st, metrics = t_step.make_train_step(cfg, t_opt.OptConfig(), mb)(st,
                                                                      batch)
    _held({k: v.numpy() for k, v in metrics.items()},
          _under(run.ranks[0], f"{case}/metric"),
          {"/".join(p): v.numpy() for p, v in tree_paths(st)},
          _under(run.ranks[0], f"{case}/after"),
          _under(run.init, f"{arch}/params"))


@pytest.mark.parametrize("case", list(ref.CASES))
def test_mesh_step_takes_no_functional_gather(run, case):
    """Every move of a placed tensor in the step (forward, the
    rematerialised recompute, backward and AdamW) goes by the raw
    collectives of ``dist/sharding.py``: the guard of each rank recorded
    no ``_c10d_functional`` all-gather, which a gloo group of CUDA
    tensors does not survive on some torch versions."""
    for r in range(WORLD):
        assert int(run.ranks[r][f"{case}/functional_gathers"]) == 0, r


@pytest.mark.parametrize("case", list(ref.CASES))
def test_metrics_are_plain_scalars_equal_on_every_rank(run, case):
    want = _under(run.ranks[0], f"{case}/metric")
    assert sorted(want) == ["grad_norm", "loss", "lr"]
    for r in range(WORLD):
        got = _under(run.ranks[r], f"{case}/metric")
        for k, v in want.items():
            assert got[k].dtype == np.float32 and got[k].shape == (), k
            np.testing.assert_array_equal(got[k], v, err_msg=(r, k))


def test_compressed_psum_over_four_processes(run):
    """``compressed_psum_leaf`` over the data axis of a (4, 1) mesh
    against the reference's ``psum`` over four devices."""
    g = ref.psum_input()
    acc = np.zeros(ref.PSUM_WIDTH, np.float32)
    for i in range(ref.PSUM_ROUNDS):
        want = run.ref[f"psum/{i}/sum"]
        for r in range(WORLD):
            np.testing.assert_array_equal(
                run.ranks[r][f"psum/{i}/residual"],
                run.ref[f"psum/{i}/residual"][r], err_msg=(i, r))
            got = run.ranks[r][f"psum/{i}/sum"]
            np.testing.assert_array_equal(got, run.ranks[0][f"psum/{i}/sum"])
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        acc = acc + run.ranks[0][f"psum/{i}/sum"]
    exact = g.sum(axis=0)
    np.testing.assert_allclose(acc / ref.PSUM_ROUNDS, exact,
                               atol=np.abs(exact).max() / 100)


def test_checkpoint_saved_on_four_ranks_restores_in_one_process(run):
    """Every rank saved the placed state after the yi step; one process
    restores the gathered state bit for bit, and so does the
    reference."""
    cfg = _port_cfg("yi-9b")
    template = t_step.state_from_numpy(tree_of(run.init, "yi-9b"), cfg,
                                       device="cpu")
    d = str(run.work / "ckpt_mesh")
    assert checkpoint.published_steps(d) == [1]
    step, got = checkpoint.restore_latest(d, template)
    want = _under(run.ranks[0], "yi/after")
    assert step == 1
    for p, v in tree_paths(got):
        np.testing.assert_array_equal(v.numpy(), want["/".join(p)])
    jst = j_ckpt.restore(d, 1, j_step.init_state(jax.random.PRNGKey(0),
                                                 ref.arch_cfg("yi-9b")))
    for p, v in ref.leaf_paths(jst):
        np.testing.assert_array_equal(np.asarray(v), want[p], err_msg=p)


def test_checkpoint_saved_in_one_process_restores_on_four_ranks(run):
    """A one-process checkpoint restored on each rank and placed gives
    each rank the block that placing the state directly gives."""
    for r in range(WORLD):
        want = _under(run.ranks[r], "yi-9b/block")
        got = _under(run.ranks[r], "restored/block")
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(r, k))


def test_elastic_resume_records_the_mesh(run):
    events = [json.loads(line) for line in
              open(run.work / "scale_events.jsonl")]
    assert len(events) == 1                       # process 0 writes it
    assert events[0]["restored"] and events[0]["step"] == 1
    assert events[0]["n_devices"] == WORLD
    assert events[0]["mesh_axes"] == {"data": 2, "model": 2}
    assert [int(r["elastic/step"]) for r in run.ranks] == [1] * WORLD


_FAKE_STEP = """
import json, sys
import torch
sys.path.insert(0, "tests")
import _ref_train_mesh_dump as ref
import _torch_mesh_ranks as ranks
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import sharding
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, device_mesh, fake_world
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

mesh = Mesh(("data", "model"), (2, 2))
cfg = configs.get_arch("yi-9b").reduced()
with fake_world(mesh):
    dm = device_mesh(mesh, "cpu")
    state = specs.state_shapes(cfg)
    state = sharding.place(state, step_mod.state_specs(state, dm), dm)
    batch = {k: torch.from_numpy(v).to("meta") for k, v in
             ref.case_batch(pipeline, "yi", cfg.vocab_size).items()}
    batch = sharding.place(batch, sharding.batch_specs(batch, dm), dm)
    _, (count, nbytes), _ = ranks.step_collectives(
        step_mod.make_train_step(cfg, opt.OptConfig(), 1), state, batch)
print(json.dumps([count.tolist(), nbytes.tolist()]))
"""


def test_fake_world_counts_the_collectives_of_four_processes(run):
    """The dry run's count (``launch/mesh.fake_world``,
    ``analysis.CollectiveCounter``) of the ``yi`` step on a fake (2, 2)
    world, in a process of its own, against what rank 0 of the four gloo
    processes issued running the same step."""
    proc = subprocess.run(
        [sys.executable, "-c", _FAKE_STEP], cwd=ROOT, capture_output=True,
        text=True, timeout=TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    count, nbytes = json.loads(proc.stdout.strip().splitlines()[-1])
    real = run.ranks[0]
    assert count == real["collectives/count"].tolist()
    assert nbytes == real["collectives/bytes"].tolist()
    assert sum(count) > 0
