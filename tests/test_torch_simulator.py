"""Parity: the port's trace generator and batched simulator
(``repro_torch/data/traces.py``, ``repro_torch/core/simulator.py``)
against the JAX package on the CPU.

Traces must be the same arrays; ``simulate_grid`` and ``simulate_trace``
must give the same stats, ``total_cycles`` and ``energy_nj`` and the same
final state, field by field and dtype included, for all nine §10.2
systems at ``scale_blocks=512`` (four shape families) and for the Fig. 11
knobs.  The Fig. 11 knobs run twice: at 512 blocks, where the t_MWW locks
bind (``locked_bypass > 0``), and at the Fig. 11 run's own 4096 blocks,
where the rotations fire (``rotates``, ``flushed_dirty > 0``): at 512
blocks the config has two supersets, so its dirty-counter limit of 12
cannot fire within a CPU-sized trace.  The CUDA-graph path is held to
this CPU path on the card by tests/test_torch_gpu.py."""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal
from repro.core import simulator as js
from repro.data import traces as jt
from repro_torch.core import simulator as ts
from repro_torch.data import traces as tt

NINE = ["d_cache", "d_cache_ideal", "s_cache", "rc_unbound", "monarch_unbound",
        "monarch_m1", "monarch_m2", "monarch_m3", "monarch_m4"]


def _fig11_knobs(mod, scale):
    """benchmarks/fig11_lifetime.py's config."""
    return dataclasses.replace(
        mod.baseline_configs(scale)["monarch_m3"], name="fig11_m3",
        l3_sets=16, t_mww_cycles=(1 << 15) * 3, dc_limit=12,
        window_budget_blocks=64)


def _traces(inpkg_blocks, n_requests, names):
    specs = {s.name: s for s in tt.crono_nas_specs(inpkg_blocks, n_requests)}
    return [(n, *tt.generate(specs[n])) for n in names]


def _assert_results_equal(want, got, key):
    assert got.name == want.name, key
    assert got.stats == want.stats, key
    assert got.total_cycles == want.total_cycles, key
    assert got.energy_nj == want.energy_nj, key


# ---------------------------------------------------------------------------
# Traces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("app", [s.name for s in jt.crono_nas_specs(1024)])
def test_traces_match_reference(app, seed):
    jspec = {s.name: s for s in jt.crono_nas_specs(2048, 3000)}[app]
    tspec = {s.name: s for s in tt.crono_nas_specs(2048, 3000)}[app]
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for want, got in zip(jt.generate(jspec, seed), tt.generate(tspec, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_trace_fingerprint_pinned():
    """The pinned fingerprint of tests/test_batched_sim.py, and the other
    constants the generator reads."""
    a, w = tt.generate(tt.crono_nas_specs(1024, 2_000)[0])    # BC
    assert int(np.int64(a.sum()) % 1_000_003) == 166957
    assert int(w.sum()) == 139
    assert (tt.N_THREADS, tt.REREFERENCE_FRAC, tt.REREFERENCE_GAP) == (
        jt.N_THREADS, jt.REREFERENCE_FRAC, jt.REREFERENCE_GAP)


# The Fig. 9/11 quick sweeps' traces (8,192 in-package blocks, 40,000
# requests), as numpy 2.0 made them for the committed baselines: sha1
# prefixes of the address and write arrays.  The port pins numpy 2.0's
# zipf sampler, so these hold under any numpy version.
QUICK_TRACE_SHA1 = {
    "BC": ("13a224fb714e", "f380e7bdb912"),
    "BFS": ("fa7188253e6a", "2e2cfea4f922"),
    "COM": ("2a1d51e21ae8", "4ffb526858ad"),
    "CON": ("ea297ded4e48", "159d5dadc095"),
    "DFS": ("54524226f243", "69c6f4ac01da"),
    "PR": ("55b7fa2b67ac", "97e9ae26c62c"),
    "SSSP": ("e00f0ae850fc", "d6bd6388126e"),
    "TRI": ("9df9d6f58a4b", "838c873bac36"),
    "FT": ("b959e57fc869", "9a1ea7bae0f3"),
    "CG": ("9604de1803ee", "26c4cc3d487a"),
    "EP": ("8782e907d5d4", "0a9006abb67d"),
}


def test_quick_sweep_traces_pinned():
    sha = lambda x: hashlib.sha1(x.tobytes()).hexdigest()[:12]
    for spec in tt.crono_nas_specs(8192, 40_000):
        a, w = tt.generate(spec)
        assert (sha(a), sha(w)) == QUICK_TRACE_SHA1[spec.name], spec.name


@pytest.mark.parametrize("a", [1.01, 1.1, 1.3, 2.5])
def test_zipf_sampler_matches_numpy_2_0(a):
    """The pinned sampler draws what numpy 2.0's ``Generator.zipf`` draws
    and leaves the stream where it does (the reference's traces call it;
    numpy 2.0 made the committed baselines)."""
    if tuple(int(v) for v in np.__version__.split(".")[:2]) >= (2, 1):
        pytest.skip("numpy >= 2.1 changed Generator.zipf; the pinned "
                    "traces above hold the sampler there")
    for seed, n in [(0, 1), (7, 5), (12345, 2500)]:
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(tt._zipf(r2, a, n), r1.zipf(a, n))
        np.testing.assert_array_equal(r2.random(4), r1.random(4))


# ---------------------------------------------------------------------------
# Configs and dynamic parameters.
# ---------------------------------------------------------------------------

def _all_cfgs(mod):
    cfgs = mod.baseline_configs(512)
    cfgs["fig11_m3"] = _fig11_knobs(mod, 512)
    return cfgs


def test_configs_and_families_match():
    jc, tc = _all_cfgs(js), _all_cfgs(ts)
    assert list(tc) == list(jc)
    for name in jc:
        assert dataclasses.asdict(tc[name]) == dataclasses.asdict(jc[name])
        assert dataclasses.asdict(ts.shape_of(tc[name])) == \
            dataclasses.asdict(js.shape_of(jc[name]))
    assert ts.n_shape_families(tc) == js.n_shape_families(jc) == 5
    assert ts.n_shape_families([tc[n] for n in NINE]) == 4
    assert ts.STAT_NAMES == js.STAT_NAMES


def test_dyn_params_match():
    """The configs stacked along the lane axis: lane g is the reference's
    ``dyn_params`` of config g."""
    jc, tc = _all_cfgs(js), _all_cfgs(ts)
    lanes = ts.dyn_params(list(tc.values()), device="cpu")
    for g, name in enumerate(jc):
        assert_tree_equal(js.dyn_params(jc[name]), ts._lane(lanes, g))
    one = ts.dyn_params([tc["monarch_m3"]], device="cpu")
    assert one.search_tags.shape == (1,)


def test_init_state_matches():
    jc, tc = _all_cfgs(js), _all_cfgs(ts)
    for name in ("d_cache", "s_cache", "monarch_m3", "fig11_m3"):
        assert_tree_equal(js.init_state(jc[name]),
                          ts.init_state(tc[name], device="cpu"))


# ---------------------------------------------------------------------------
# The nine systems at scale_blocks=512: simulate_grid and simulate_trace.
# ---------------------------------------------------------------------------

BASE_REQUESTS = 1000


@pytest.fixture(scope="module")
def baseline_grids():
    jc, tc = js.baseline_configs(512), ts.baseline_configs(512)
    trace_list = _traces(jc["monarch_unbound"].inpkg_blocks, BASE_REQUESTS,
                         ["BC", "EP"])
    want = js.simulate_grid(jc, trace_list, return_state=True)
    got = ts.simulate_grid(tc, trace_list, return_state=True, device="cpu")
    return trace_list, want, got


@pytest.mark.parametrize("name", NINE)
def test_grid_matches_reference(baseline_grids, name):
    trace_list, (jres, jst), (tres, tst) = baseline_grids
    assert set(tres) == set(jres)
    for tname, _, _ in trace_list:
        key = (name, tname)
        _assert_results_equal(jres[key], tres[key], key)
        assert_tree_equal(jst[key], tst[key], str(key))


@pytest.mark.parametrize("name", ["d_cache", "s_cache", "rc_unbound",
                                  "monarch_m2"])
def test_trace_matches_reference(baseline_grids, name):
    """One config of each family through the one-lane path: equal to the
    reference's ``simulate_trace`` and to its own lane of the grid."""
    trace_list, _, (tres, tst) = baseline_grids
    tname, addrs, wr = trace_list[1]
    want, jstate = js.simulate_trace(js.baseline_configs(512)[name], addrs,
                                     wr, return_state=True)
    got, tstate = ts.simulate_trace(ts.baseline_configs(512)[name], addrs, wr,
                                    return_state=True, device="cpu")
    _assert_results_equal(want, got, name)
    assert_tree_equal(jstate, tstate, name)
    _assert_results_equal(tres[(name, tname)], got, name)


# ---------------------------------------------------------------------------
# The Fig. 11 knobs: t_MWW locks at 512 blocks, rotations at 4096.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,n_requests,apps,fired", [
    (512, 3100, ["DFS", "FT"], ["locked_bypass"]),
    (4096, 1500, ["FT", "EP"], ["rotates", "flushed_dirty"]),
])
def test_fig11_knobs_match_reference(scale, n_requests, apps, fired):
    jcfg, tcfg = _fig11_knobs(js, scale), _fig11_knobs(ts, scale)
    trace_list = _traces(jcfg.inpkg_blocks, n_requests, apps)
    jres, jst = js.simulate_grid([jcfg], trace_list, return_state=True)
    tres, tst = ts.simulate_grid([tcfg], trace_list, return_state=True,
                                 device="cpu")
    for key in jres:
        _assert_results_equal(jres[key], tres[key], key)
        assert_tree_equal(jst[key], tst[key], str(key))
        for stat in fired:      # the wear path did work in this run
            assert tres[key].stats[stat] > 0, (key, stat)
    if scale == 512:
        _, addrs, wr = trace_list[0]
        want, jstate = js.simulate_trace(jcfg, addrs, wr, return_state=True)
        got, tstate = ts.simulate_trace(tcfg, addrs, wr, return_state=True,
                                        device="cpu")
        _assert_results_equal(want, got, "simulate_trace")
        assert_tree_equal(jstate, tstate, "simulate_trace")


# ---------------------------------------------------------------------------
# Argument checks.
# ---------------------------------------------------------------------------

def test_grid_rejects_mismatched_trace_lengths():
    a, w = np.zeros(100, np.int64), np.zeros(100, bool)
    with pytest.raises(ValueError, match="length"):
        ts.simulate_grid({"d_cache": ts.baseline_configs(512)["d_cache"]},
                         [("t0", a, w), ("t1", a[:50], w[:50])],
                         device="cpu")


def test_empty_grid_and_default_device():
    cfg = ts.baseline_configs(512)["d_cache"]
    assert ts.simulate_grid([], [], device="cpu") == {}
    assert ts.simulate_grid([cfg], [], return_state=True,
                            device="cpu") == ({}, {})
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.simulate_grid([cfg], [("t", np.zeros(4, np.int64),
                                  np.zeros(4, bool))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.simulate_trace(cfg, np.zeros(4, np.int64), np.zeros(4, bool))
