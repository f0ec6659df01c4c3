"""The mesh layer of the port's launchers: ``launch/train.py`` under
``torchrun`` with two CPU processes (gloo) trains, saves and restarts at
the saved step, and refuses a production mesh it cannot fill;
``launch/serve.py`` and ``launch/httpd.py`` under ``torchrun`` serve as
one process does; the spec-to-placement rule, ``device_mesh`` and a
placed step on a world of one in process.

Bounds: the two-process run's losses within 1e-3 relative of the
one-process launcher's (the gradient all-reduce adds in another order);
on a world of one a placed step is the plain step within 1e-6 relative;
served over the (2, 1) mesh, the report lines and answers equal one
process's (each process serves its own row of every batch whole).
"""
from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import sharding
from repro_torch.launch import serve as t_serve
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


# ---------------------------------------------------------------------------
# The launchers under torchrun, two CPU processes on a (2, 1) mesh.
# ---------------------------------------------------------------------------

SERVE_TIMEOUT = 240


def _serving(module, *args, mesh: bool):
    """``module`` under torchrun on two processes (``mesh``) or as one
    process, stderr merged into its stdout pipe."""
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node=2", "-m", module, *args] if mesh else
           [sys.executable, "-m", module, *args])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


SERVE_ARGV = ["--arch", "yi-9b", "--reduced", "--device", "cpu",
              "--requests", "6", "--decode-tokens", "3", "--sync-admit"]
_VARYING = re.compile(r"\d+ requests in [\d.]+s")


def test_torchrun_serve_matches_one_process(capsys):
    proc = _serving("repro_torch.launch.serve", "--mesh", "host",
                    *SERVE_ARGV, mesh=True)
    out, _ = proc.communicate(timeout=SERVE_TIMEOUT)
    assert proc.returncode == 0, out
    mesh = [line for line in out.splitlines() if line.startswith("[serve]")]
    assert mesh[0].startswith("[serve] yi-9b placed over mesh {'data': 2, "
                              "'model': 1} (2 processes, gloo, cpu)")
    t_serve.main(SERVE_ARGV)
    one = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("[serve]")]
    # the same report lines, once (process 0), but for the time
    assert [_VARYING.sub("", line) for line in mesh[1:]] == \
        [_VARYING.sub("", line) for line in one]


def test_serve_production_mesh_needs_its_devices():
    with pytest.raises(RuntimeError,
                       match=r"need 256 devices for mesh \(16, 16\), have 1"):
        t_serve.main(SERVE_ARGV + ["--mesh", "single"])


def _post(port, tokens):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps({"tokens": tokens.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


HTTPD_ARGV = ["--arch", "yi-9b", "--reduced", "--device", "cpu", "--port",
              "0", "--admit-after-reads", "0", "--batch-window-ms", "0"]


def _port(proc, lines: list) -> int:
    """The port of the "listening on" line, reading ``proc``'s output
    into ``lines`` until it."""
    deadline = time.monotonic() + SERVE_TIMEOUT
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        assert line, "".join(lines[-30:])
        lines.append(line)
        m = re.search(r"listening on http://127.0.0.1:(\d+)", line)
        if m:
            return int(m[1])
    raise AssertionError("".join(lines[-30:]))


def test_torchrun_httpd_matches_one_process():
    """Process 0 answers two requests (the second a prefix hit) over the
    (2, 1) mesh, the same tokens and accounting as one process (both
    booted at once); between them process 0 sends keep-alives, which
    process 1 passes over; a SIGTERM to torchrun drains both processes."""
    reqs = [np.arange(1, 41, dtype=np.int32).reshape(1, 40)] * 2
    procs = {name: _serving("repro_torch.launch.httpd", *args, *HTTPD_ARGV,
                            mesh=name == "mesh")
             for name, args in (("mesh", ("--mesh", "host",
                                          "--mesh-keepalive-s", "0.1")),
                                ("one", ()))}
    lines = {name: [] for name in procs}
    answers = {}
    try:
        for name, proc in procs.items():
            port = _port(proc, lines[name])
            answers[name] = [_post(port, reqs[0])]
            time.sleep(0.5)                  # idle: keep-alives
            answers[name].append(_post(port, reqs[1]))
            proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=SERVE_TIMEOUT)
            lines[name] += out.splitlines()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    mesh = lines["mesh"]
    log = "\n".join(line.rstrip("\n") for line in mesh[-30:])
    assert any("(1 workers," in line for line in mesh), log
    assert any(line.startswith("[httpd] drained in") and
               "2 served / 0 errors" in line for line in mesh), log
    drained = [re.match(r"\[httpd\] rank 1 drained: 2 batches served "
                        r"\((\d+) keep-alives\)", line) for line in mesh]
    assert any(m and int(m[1]) >= 1 for m in drained), log
    for got, want in zip(answers["mesh"], answers["one"]):
        for key in ("tokens", "chunks", "hit_chunks", "resumed_chunks",
                    "admitted"):
            assert got[key] == want[key], (key, answers)
    assert answers["mesh"][1]["resumed_chunks"] == 2


def test_torchrun_httpd_stops_when_hit_masks_diverge():
    """Process 1's replica answers one chunk wrongly: the request gets an
    error, process 0 stops serving and sends nothing more, and both
    processes exit with the error instead of serving on out of step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2",
         str(ROOT / "tests" / "_torch_httpd_diverged.py"), "--mesh",
         "host", *HTTPD_ARGV], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    try:
        port = _port(proc, lines)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, np.arange(1, 41, dtype=np.int32).reshape(1, 40))
        assert err.value.code == 500
        out, _ = proc.communicate(timeout=SERVE_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines) + out
    assert proc.returncode != 0, text[-3000:]
    why = "1 of 2 chunk hits differ across the mesh's index replicas"
    assert f"[httpd] stopping: process 0: {why}" in text, text[-3000:]
    assert f"[httpd] rank 1 stopped: process 1: {why}" in text, text[-3000:]
    assert "0 served / 1 errors" in text, text[-3000:]
