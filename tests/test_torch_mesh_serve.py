"""The port's serving over a (2, 2) ("data", "model") mesh of four gloo
processes on the CPU, held to the reference's one-device request loop
(the launchers' ``--mesh`` under ``torchrun``:
``tests/test_torch_mesh_launch.py``).

One module fixture starts four ranks of ``tests/_torch_mesh_serve_ranks.py``
(torch only) on the reference's parameters and, while they run, serves
the same requests through the reference's ``run_request_loop`` on one
device.  Each rank places the parameters by ``param_specs`` (yi-9b's and
qwen3-moe's attention split over ``model``, qwen3-moe's experts over
``model`` by their hidden width), keeps its own index replica, and checks
every lookup's hit mask against the others'.  Bounds:

* chunks, hits, resumed chunks and admissions exactly; the index
  replica's ``slot_of`` and bits exactly (inline admission on both
  sides);
* decoded tokens by the greedy-margin rule (``assert_greedy_agree``)
  with the reference's own top-1/top-2 gaps: the mesh adds partial sums
  over ``model`` in another order than one device;
* every rank's records equal every other rank's, bit for bit;
* under the wall wear clock, with throttles, every replica's placement,
  throttles and wear state equal every other's (the shared clock).
"""
from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import _torch_mesh_serve_ranks as ranks
from repro import configs as j_configs
from repro.launch import serve as j_serve
from repro.models import transformer as j_tf
from repro.serve import admit_queue as j_aq
from repro.serve import kv_index as j_kv
from test_torch_model import assert_greedy_agree
from test_torch_serve import _j_decode_fn, _j_plain_fns

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _reference(arch, resume, jp):
    """The reference's one-device loop over the ranks' requests: its
    records, its decode's top-2 gaps and its index."""
    jcfg = j_configs.get_arch(arch).reduced()
    ji = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**ranks.kv_config(resume)),
                             slab_store=j_kv.KVSlabStore() if resume
                             else None)
    jq = j_aq.AdmitQueue(ji, background=False)
    gaps: list = []
    max_seq = ranks.S + ranks.DECODE
    if resume:
        pf, _, eng = j_serve.build_model_fns(
            jp, jcfg, max_seq=max_seq, decode_tokens=ranks.DECODE, index=ji,
            resume=True)
        df = _j_decode_fn(eng, gaps)
    else:
        pf, df = _j_plain_fns(jp, jcfg, max_seq, gaps)
    recs = j_serve.run_request_loop(jq, ranks.requests(jcfg.vocab_size),
                                    prefill_fn=pf, decode_fn=df)
    jq.close()
    return SimpleNamespace(records=recs, gaps=gaps, index=ji)


def write_params(work: Path, archs) -> dict:
    """The reference's reduced parameters of ``archs`` to
    ``work/params.npz`` (``{arch}/{leaf path}``, bf16 as uint16 bits);
    returns the JAX trees."""
    jps, flat = {}, {}
    for arch in archs:
        jps[arch] = j_tf.init_params(jax.random.PRNGKey(0),
                                     j_configs.get_arch(arch).reduced())
        for path, leaf in jax.tree_util.tree_leaves_with_path(jps[arch]):
            a = np.asarray(leaf)
            key = "/".join([arch] + [p.key for p in path])
            flat[key] = a.view(np.uint16) if a.dtype.name == "bfloat16" \
                else a
    np.savez(work / "params.npz", **flat)
    return jps


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_serve")
    jps = write_params(work, ranks.CASES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = []
    for r in range(ranks.WORLD):
        with open(work / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" /
                                     "_torch_mesh_serve_ranks.py"),
                 str(r), str(port), str(work)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    try:
        ref = {arch: _reference(arch, resume, jps[arch])
               for arch, resume in ranks.CASES.items()}
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (work / f"log{r}.txt").read_text()[-4000:]
    return SimpleNamespace(ref=ref, ranks=[dict(np.load(work / f"rank{r}.npz"))
                                           for r in range(ranks.WORLD)])


@pytest.mark.parametrize("arch", list(ranks.CASES))
def test_mesh_loop_matches_reference(run, arch):
    ref = run.ref[arch]
    got = run.ranks[0]
    for i, j in enumerate(ref.records):
        counts = got[f"{arch}/rec{i}/counts"]
        assert tuple(counts) == (j.chunks, j.hit_chunks, j.resumed_chunks,
                                 j.admitted), i
        decoded = got[f"{arch}/rec{i}/decoded"]
        assert decoded.shape == j.decoded.shape == (ranks.B, ranks.DECODE)
        assert_greedy_agree(decoded, j.decoded, ref.gaps[i])
    assert sum(r.hit_chunks for r in ref.records) > 0
    if ranks.CASES[arch]:
        assert sum(r.resumed_chunks for r in ref.records) > 0


@pytest.mark.parametrize("arch", list(ranks.CASES))
def test_index_replica_is_the_reference_index(run, arch):
    ji = run.ref[arch].index
    want = np.array([[k, *v] for k, v in sorted(ji.slot_of.items())],
                    np.int64)
    for r in range(ranks.WORLD):
        np.testing.assert_array_equal(run.ranks[r][f"{arch}/slot_of"], want)
        np.testing.assert_array_equal(run.ranks[r][f"{arch}/bits"],
                                      np.asarray(ji.bits))


def test_every_rank_serves_the_same_records(run):
    want = run.ranks[0]
    for r in range(1, ranks.WORLD):
        got = run.ranks[r]
        assert sorted(got) == sorted(want)
        for k in want:
            if k not in ("diverged", "after"):    # name their process
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=(r, k))


def test_diverged_hit_masks_raise_on_every_rank(run):
    for r in range(ranks.WORLD):
        msg = str(run.ranks[r]["diverged"])
        assert re.match(rf"process {r}: 1 of 6 chunk hits differ across "
                        "the mesh's index replicas", msg), msg
        # the mesh has stopped: the next lookup raises the same, at once
        assert str(run.ranks[r]["after"]) == msg


def test_replicas_share_the_wear_clock_under_throttles(run):
    admissions, throttled, _ = run.ranks[0]["wear/counts"]
    assert throttled > 0 and admissions > 0
    assert float(run.ranks[0]["wear/clock"]) > 0
    keys = [k for k in run.ranks[0] if k.startswith("wear/")]
    assert "wear/state/write_counter" in keys
    for r in range(1, ranks.WORLD):
        for k in keys:
            np.testing.assert_array_equal(run.ranks[r][k], run.ranks[0][k],
                                          err_msg=(r, k))
