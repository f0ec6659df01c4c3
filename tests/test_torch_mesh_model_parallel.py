"""The port's serving split over ``model``: two gloo processes on a
``(1, 2)`` ("data", "model") mesh on the CPU, every weight split as
``param_specs`` places it, held to the reference's one-device request
loop, with no functional all-gather on the path.

One module fixture writes the reference's parameters for reduced yi-9b
(resume on), falcon-mamba-7b and zamba2-2.7b (resume off), starts the
two ``serve`` ranks of ``tests/_torch_mesh_mp_ranks.py`` (torch only)
and, while they run, serves the same requests through the reference's
``run_request_loop`` on one device (``test_torch_mesh_serve._reference``).
Each rank serves under a dispatch mode that raises on DTensor's
functional all-gather (``_c10d_functional``), the op whose gloo group of
CUDA tensors dies on some torch versions (ROADMAP Queue 3 item 18), so a
serving path that reaches it fails here on the CPU.  Bounds, as
``tests/test_torch_mesh_serve.py``'s: chunks, hits, resumed chunks and
admissions exactly; tokens by the greedy-margin rule; both ranks' records
bit for bit.  An SSM decode step gathers its activations, not its
weights: its all-gather bytes are :func:`step_activation_bytes` exactly.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import _torch_mesh_mp_ranks as mp
import _torch_mesh_serve_ranks as ranks
from repro import configs as j_configs
from test_torch_mesh_serve import _free_port, _reference, write_params
from test_torch_model import assert_greedy_agree

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 150


def start_ranks(mode: str, world: int, work: Path) -> list:
    """``world`` processes of ``_torch_mesh_mp_ranks.py mode``, each
    logging to ``work/{mode}_log{r}.txt``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = []
    for r in range(world):
        with open(work / f"{mode}_log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_mesh_mp_ranks.py"),
                 mode, str(r), str(port), str(work)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def finish_ranks(mode: str, procs: list, work: Path) -> list:
    """Wait for every rank under :data:`TIMEOUT` (killing what is left),
    require a clean exit of each, and load their files."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            (work / f"{mode}_log{r}.txt").read_text()[-4000:]
    return [dict(np.load(work / f"{mode}{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_mp")
    jps = write_params(work, mp.CASES)
    procs = start_ranks("serve", mp.SERVE_WORLD, work)
    try:
        ref = {arch: _reference(arch, resume, jps[arch])
               for arch, resume in mp.CASES.items()}
    finally:
        got = finish_ranks("serve", procs, work)
    return SimpleNamespace(ref=ref, ranks=got, params=jps)


def step_activation_bytes(cfg, rows: int) -> int:
    """All-gather output bytes of one placed SSM decode step over a
    ``model`` axis that splits every SSM weight's last dimension: each
    layer gathers its step's activations whole, Mamba-1 ``xh`` before
    and after the conv (bf16), ``z`` and ``dt``'s product (float32 in a
    layer group, where the step keeps them unrounded, else bf16), the
    ``x_proj`` product (dt rank + 2N, bf16) and the output (d_model,
    bf16); Mamba-2 ``z`` and ``dt``'s heads (float32 in a group, else
    bf16), ``xBC`` before and after the conv (d_inner + 2N, bf16) and the
    output."""
    group, n_groups, rem = cfg.scan_groups()
    di, n, d = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.d_model
    per = 0
    for kind, fused in [(k, True) for k in group] * n_groups + \
            [(k, False) for k in rem]:
        f = 4 if fused else 2
        if kind == "mamba1":
            r = max(d // 16, 1)
            per += 2 * di * 2 + f * di * 2 + 2 * (r + 2 * n) + 2 * d
        elif kind == "mamba2":
            h = di // cfg.ssm_head_dim
            per += f * (di + h) + 2 * (di + 2 * n) * 2 + 2 * d
    return rows * per


def ssm_param_bytes(jp) -> int:
    """Bytes of every SSM weight of a parameter tree."""
    return sum(np.asarray(leaf).nbytes
               for path, leaf in jax.tree_util.tree_leaves_with_path(jp)
               if any(getattr(p, "key", None) == "ssm" for p in path))


@pytest.mark.parametrize("arch", list(mp.CASES))
def test_model_parallel_loop_matches_reference(run, arch):
    ref = run.ref[arch]
    for r, got in enumerate(run.ranks):
        for i, j in enumerate(ref.records):
            counts = got[f"{arch}/rec{i}/counts"]
            assert tuple(counts) == (j.chunks, j.hit_chunks, j.resumed_chunks,
                                     j.admitted), (r, i)
            decoded = got[f"{arch}/rec{i}/decoded"]
            assert decoded.shape == j.decoded.shape == (ranks.B,
                                                        ranks.DECODE)
            assert_greedy_agree(decoded, j.decoded, ref.gaps[i])
            np.testing.assert_array_equal(
                decoded, run.ranks[0][f"{arch}/rec{i}/decoded"])
    assert sum(r.hit_chunks for r in ref.records) > 0
    if mp.CASES[arch]:
        assert sum(r.resumed_chunks for r in ref.records) > 0


@pytest.mark.parametrize("arch", list(mp.CASES))
def test_the_loop_gathers_by_raw_collectives(run, arch):
    """The loop ran to its end under the guard (a functional all-gather
    would have stopped the rank) and gathered with the raw collective:
    the vocabulary of every greedy step's logits at least."""
    count, nbytes = run.ranks[0][f"{arch}/gathers"]
    cfg = j_configs.get_arch(arch).reduced()
    steps = len(run.ref[arch].records) * ranks.DECODE
    assert count >= steps
    assert nbytes >= steps * ranks.B * cfg.vocab_size * 4


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_decode_gathers_activations_not_weights(run, arch):
    cfg = j_configs.get_arch(arch).reduced()
    want = step_activation_bytes(cfg, ranks.B)
    for got in run.ranks:
        count, nbytes = got[f"{arch}/step_gathers"]
        assert nbytes == want, (nbytes, want)
        assert count > 0
    assert want * 20 < ssm_param_bytes(run.params[arch])


def test_guard_fires_on_dtensor_shard_to_replicate(run):
    for got in run.ranks:
        fired = str(got["guard/fired"])
        assert fired.startswith("_c10d_functional.all_gather"), fired
        np.testing.assert_array_equal(got["guard/raw"],
                                      np.arange(8, dtype=np.float32))
