"""Parity: the port's ``HopscotchTable`` (host and device backends, on the
CPU) against the JAX ``HopscotchTable(backend="host")`` on the schedules of
tests/test_hashtable_device_differential.py — buckets, values, stats and
the §8 wear report compared after every mutation — plus the port's
``ycsb_ops``, ``make_config`` and ``record_writes`` against the
reference's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps.hashtable import HopscotchTable as JTable
from repro.core import wear as jw
from repro.data import pipeline as j_pipe
from repro_torch.apps.hashtable import HopscotchTable as TTable
from repro_torch.core import wear as tw
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels.hopscotch import ops as t_hop


def _trio(log2_size: int, window: int, wear_on: bool = True):
    """The reference (host) and the port's host and device tables."""
    kw = dict(n_supersets=8, t_mww_cycles=64, blocks_per_superset=4)
    ref = JTable(log2_size, window=window,
                 wear_cfg=jw.WearConfig(**kw) if wear_on else None)
    ports = [TTable(log2_size, window=window,
                    wear_cfg=tw.WearConfig(**kw) if wear_on else None,
                    backend=b, device="cpu") for b in ("host", "device")]
    return ref, ports


def _assert_same(ref, ports, msg: str):
    for t in ports:
        t._sync_host()
        np.testing.assert_array_equal(t.keys, ref.keys, err_msg=f"{msg} keys")
        np.testing.assert_array_equal(t.vals, ref.vals, err_msg=f"{msg} vals")
        assert (dataclasses.astuple(t.stats)
                == dataclasses.astuple(ref.stats)), (msg, t.backend)
        assert t.n == ref.n, msg
        if ref.wear_cfg is not None:
            assert t.wear_report() == ref.wear_report(), (msg, t.backend)


def _each(ref, ports, method, *args):
    """Call ``method`` on every table; all must return the same."""
    want = getattr(ref, method)(*args)
    for t in ports:
        got = getattr(t, method)(*args)
        if isinstance(want, tuple):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            assert got == want, (method, args, t.backend)
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [4, 8])
def test_randomized_schedule_bit_identical(seed, window):
    rng = np.random.default_rng(seed)
    ref, ports = _trio(log2_size=6, window=window)
    universe = rng.choice(np.arange(1, 1 << 20, dtype=np.uint64),
                          size=90, replace=False)
    live: list[int] = []
    for step in range(140):
        op = rng.random()
        if op < 0.6 or not live:
            k = int(universe[rng.integers(0, universe.size)])
            v = int(rng.integers(1, 1 << 60))
            _each(ref, ports, "insert", k, v)
            if k not in live:
                live.append(k)
        elif op < 0.8:
            k = live.pop(rng.integers(0, len(live)))
            assert _each(ref, ports, "delete", k) is True
            assert _each(ref, ports, "delete", k) is False
        else:
            _each(ref, ports, "lookup_monarch", rng.choice(universe, size=13))
        _assert_same(ref, ports, f"seed={seed} step={step}")
    assert ref.stats.inserts > 0 and ref.stats.deletes > 0
    for t in ports:
        assert t.load == ref.load
    _each(ref, ports, "lookup_baseline", universe[:20])
    _assert_same(ref, ports, "baseline")
    life = [t.lifetime_estimate() for t in [ref, *ports]]
    assert life[1] == life[2] and dataclasses.astuple(life[1]) == \
        dataclasses.astuple(life[0])


def test_hop_chain_saturation_and_duplicate_updates():
    ref, ports = _trio(log2_size=5, window=4)
    keys = np.arange(1, 27, dtype=np.uint64) * np.uint64(0x9E3779B9)
    for k in keys:
        _each(ref, ports, "insert", int(k), int(k) ^ 0xFF)
        _assert_same(ref, ports, f"saturate k={k}")
    assert ref.stats.swaps > 0
    for k in keys[:9]:
        _each(ref, ports, "insert", int(k), 7)
    _assert_same(ref, ports, "dup updates")
    vals, hits = _each(ref, ports, "lookup_monarch", keys[:9])
    assert hits.all() and (vals == 7).all()


def test_table_full_rehashes_identically():
    ref, ports = _trio(log2_size=3, window=2)
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(1, 1 << 30, size=60,
                                  dtype=np.uint64))[:40]
    for i, k in enumerate(keys):
        _each(ref, ports, "insert", int(k), i + 1)
        _assert_same(ref, ports, f"fill i={i}")
    assert ref.stats.rehashes >= 2 and ref.n > 8
    _, hits = _each(ref, ports, "lookup_monarch", keys)
    assert hits.all()


def test_device_backend_without_wear_tracking():
    ref, ports = _trio(log2_size=5, window=8, wear_on=False)
    for k in range(1, 40):
        _each(ref, ports, "insert", k, k * 2)
    _assert_same(ref, ports, "no-wear")
    for t in ports:
        with pytest.raises(ValueError, match="wear"):
            t.wear_report()


def test_device_planes_and_lookup_launches():
    """The device backend keeps its table in int32 planes on its device
    and answers a lookup batch with one window-search launch."""
    t = TTable(6, window=8, backend="device", device="cpu")
    for k in range(1, 30):
        t.insert(k << 33 | k, k)
    assert t._pk_lo.dtype == torch.int32 and t._pk_lo.shape == (64 + 16,)
    before = t_hop.LAUNCH_COUNT
    vals, hits = t.lookup_monarch(np.arange(1, 40, dtype=np.uint64) << 33
                                  | np.arange(1, 40, dtype=np.uint64))
    assert t_hop.LAUNCH_COUNT == before + 1
    assert hits[:29].all() and not hits[29:].any()
    np.testing.assert_array_equal(vals[:29], np.arange(1, 30))


def test_knobs_raise_value_error():
    with pytest.raises(ValueError, match="backend"):
        TTable(5, backend="gpu", device="cpu")
    with pytest.raises(ValueError, match="plane_format"):
        TTable(5, plane_format="packed16", device="cpu")
    assert TTable(5, plane_format="packed8", device="cpu").plane_format == \
        "packed8"
    with pytest.raises(ValueError, match="empty sentinel"):
        TTable(5, device="cpu").insert(0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTable(5)


# ---------------------------------------------------------------------------
# The helpers the table and its benchmark use.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(n_keys=1000, n_ops=500),
                                 dict(n_keys=7, n_ops=300, seed=3),
                                 dict(n_keys=1 << 17, n_ops=8192,
                                      read_fraction=0.5, zipf_a=1.5,
                                      seed=11)])
def test_ycsb_ops_matches_reference(cfg):
    jk, jr = j_pipe.ycsb_ops(j_pipe.YcsbConfig(**cfg))
    tk, tr = t_pipe.ycsb_ops(t_pipe.YcsbConfig(**cfg))
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tr, jr)
    assert tk.dtype == np.uint64 and (tk != 0).all()


@pytest.mark.parametrize("args", [(8,), (16, 5, 3.0, 1e7),
                                  (4, 3, 10.0, 1e8, "wall")])
def test_make_config_matches_reference(args):
    assert dataclasses.asdict(tw.make_config(*args)) == \
        dataclasses.asdict(jw.make_config(*args))


def _state_arrays(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x
                        for k, x in _state_arrays(v).items()})
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("seed,n,wr_shift,dc_limit", [
    (0, 64, 3, 5), (1, 100, 9, 8192), (2, 32, 2, 3)])
def test_record_writes_matches_reference(seed, n, wr_shift, dc_limit):
    """Random traces with inactive lanes and rotations: state, rotate
    flags and flush counts equal the reference's scan."""
    rng = np.random.default_rng(seed)
    kw = dict(n_supersets=8, t_mww_cycles=40, blocks_per_superset=2,
              wr_shift=wr_shift, dc_limit=dc_limit)
    ss = rng.integers(0, 8, n).astype(np.int32)
    dirty = rng.random(n) < 0.7
    cycles = np.cumsum(rng.integers(0, 5, n)).astype(np.int32)
    active = rng.random(n) < 0.8
    jcfg = jw.WearConfig(**kw)
    js, jr, jf = jw.record_writes(jw.init_state(jcfg), jw.dyn_of(jcfg), ss,
                                  dirty, cycles, active)
    tcfg = tw.WearConfig(**kw)
    ts, tr, tf = tw.record_writes(tw.init_state(tcfg, "cpu"),
                                  tw.dyn_of(tcfg, "cpu"), ss, dirty, cycles,
                                  torch.from_numpy(active))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    want = _state_arrays(js)
    got = _state_arrays(ts)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if seed != 1:
        assert int(tr.sum()) > 0      # the rotate branch ran


def test_maybe_rebase_folds_the_clock():
    cfg = tw.WearConfig(n_supersets=4, t_mww_cycles=10)
    st = tw.init_state(cfg, "cpu")
    st = dataclasses.replace(st, window_start=torch.full(
        (4,), tw.CLOCK_REBASE_AT + 5, dtype=torch.int32))
    same, op = tw.maybe_rebase(st, 7)
    assert op == 7 and same is st
    folded, op = tw.maybe_rebase(st, tw.CLOCK_REBASE_AT + 9)
    assert op == 9 and folded.window_start.tolist() == [5] * 4
