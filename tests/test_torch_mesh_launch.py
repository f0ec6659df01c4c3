"""The mesh layer of the port's training launcher: ``launch/train.py``
under ``torchrun`` with two CPU processes (gloo) trains, saves and
restarts at the saved step, and refuses a production mesh it cannot fill;
the spec-to-placement rule, ``device_mesh`` and a placed step on a world
of one in process.

Bounds: the two-process run's losses within 1e-3 relative of the
one-process launcher's (the gradient all-reduce adds in another order);
on a world of one a placed step is the plain step within 1e-6 relative.
"""
from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import sharding
from repro_torch.launch import train as t_launch
from repro_torch.launch.mesh import (device_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import layers
from repro_torch.pytree import tree_paths
from repro_torch.train import step as t_step

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--arch", "yi-9b", "--reduced", "--device", "cpu", "--batch", "2",
        "--seq", "16"]


def _torchrun(*args, nproc: int = 2):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train",
           *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)


def _losses(out: str) -> dict:
    return {int(m[1]): float(m[2]) for m in
            re.finditer(r"\[launch\] step +(\d+) loss +([-\d.]+)", out)}


def test_torchrun_host_mesh_trains_saves_and_restarts(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = ARGV + ["--mesh", "host", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    first = _torchrun(*argv, "--steps", "2")
    assert first.returncode == 0, first.stdout + first.stderr
    for r in (0, 1):
        assert (f"on 2 devices {{'data': 2, 'model': 1}} (rank {r} on cpu, "
                "gloo)") in first.stdout
    again = _torchrun(*argv, "--steps", "3")
    assert again.returncode == 0, again.stdout + again.stderr
    assert "elastic restore at step 2 onto 2 devices" in again.stdout
    assert again.stdout.count("[launch] done") == 1      # rank 0 reports
    events = [json.loads(line) for line in
              open(os.path.join(ckpt, "scale_events.jsonl"))]
    assert [(e["restored"], e["step"]) for e in events] == [(False, 0),
                                                            (True, 2)]
    assert all(e["n_devices"] == 2 and
               e["mesh_axes"] == {"data": 2, "model": 1} for e in events)
    # the same three steps in one process
    _, plain = t_launch.main(ARGV + ["--steps", "3"])
    got = {**_losses(first.stdout), **_losses(again.stdout)}
    assert sorted(got) == [0, 1, 2]
    for h in plain:
        assert got[h["step"]] == pytest.approx(h["loss"], rel=1e-3)


def test_torchrun_production_mesh_needs_its_devices():
    res = _torchrun(*ARGV, "--mesh", "single", "--steps", "1")
    assert res.returncode != 0
    assert "need 256 devices for mesh (16, 16), have 2" in res.stderr


def test_placements_follow_the_spec():
    names = ("data", "model")
    assert sharding.placements((None, "model"), names) == [Replicate(),
                                                           Shard(1)]
    assert sharding.placements(("data", None, "model"), names) == [
        Shard(0), Shard(2)]
    assert sharding.placements((("pod", "data"), None),
                               ("pod", "data", "model")) == [
        Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), ("pod", "data", "model"))


def test_device_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="need 256 devices"):
        device_mesh(make_production_mesh(), "cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        device_mesh(make_production_mesh(multi_pod=True), "cpu")
    assert device_mesh(make_host_mesh(1), "cpu") is None   # no group


def test_seq_shard_leaves_a_plain_tensor():
    import dataclasses
    cfg = dataclasses.replace(configs.get_arch("yi-9b").reduced(),
                              attn_seq_shard=("data",))
    t = torch.ones(2, 4, 3)
    assert layers._seq_shard(t, cfg) is t


@pytest.fixture
def world_of_one():
    dist = torch.distributed
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield device_mesh(make_host_mesh(1), "cpu")
    finally:
        dist.destroy_process_group()


def test_placed_step_on_a_world_of_one(world_of_one):
    """``init_state`` placed on a (1, 1) mesh, a placed batch, one step:
    the plain step's metrics and state, and ``gather`` gives full
    tensors back."""
    dm = world_of_one
    cfg = configs.get_arch("yi-9b").reduced()
    plain = t_step.init_state(0, cfg, device="cpu")
    placed = t_step.init_state(0, cfg, device="cpu", device_mesh=dm)
    assert all(isinstance(v, DTensor) for _, v in tree_paths(placed))
    batch = pipeline.batch_at(pipeline.DataConfig(cfg.vocab_size, 16, 2, 1),
                              0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb = sharding.place(tb, sharding.batch_specs(tb, dm), dm)
    step = t_step.make_train_step(cfg)
    plain, pm = step(plain, batch)
    placed, qm = step(placed, tb)
    for k in pm:
        assert not isinstance(qm[k], DTensor)
        assert float(qm[k]) == pytest.approx(float(pm[k]), rel=1e-6), k
    full = sharding.gather(placed)
    for (p, a), (_, b) in zip(tree_paths(full), tree_paths(plain)):
        assert not isinstance(a, DTensor)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg="/".join(p))
