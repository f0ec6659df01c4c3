"""Parity: the port's §8 wear machinery against ``repro.core.wear``, step
for step over random write traces.  Every WearState field must be
exactly equal and keep its dtype (int32 counters and stamps, int8 SWT
flags)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wear as jw
from repro_torch.core import wear as tw


# The reference's functions, jitted once (the knobs are static pytree
# fields, so each config compiles once) to keep the traces fast.
_j_record_write = jax.jit(jw.record_write)
_j_is_locked = jax.jit(jw.is_locked)
_j_would_exceed = jax.jit(jw.window_would_exceed)
_j_write_rows = jax.jit(jw.record_write_rows)


def _assert_state_equal(js, ts):
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if f.name == "offsets":
            for g in dataclasses.fields(a):
                ga, gb = getattr(a, g.name), getattr(b, g.name)
                assert gb.dtype == torch.int32
                assert int(ga) == int(gb), (f.name, g.name)
            continue
        want = np.asarray(a)
        got = b.cpu().numpy()
        assert got.dtype == want.dtype, (f.name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def _cfgs(**kw):
    base = dict(n_supersets=8, m_writes=2, blocks_per_superset=3,
                t_mww_cycles=50)
    base.update(kw)
    return jw.WearConfig(**base), tw.WearConfig(**base)


@pytest.mark.parametrize("kw", [
    {"dc_limit": 6},                             # DC rotations fire
    {"wr_shift": 2, "dc_limit": 1 << 30},        # WR rotations fire
    {"wr_shift": 32, "dc_limit": 1 << 30, "wc_limit": 1 << 30},  # serving
])
def test_record_write_trace(kw, rng):
    jc, tc = _cfgs(**kw)
    js, ts = jw.init_state(jc), tw.init_state(tc, device="cpu")
    cycle = 0
    for step in range(100):
        s = int(rng.integers(0, 8))
        dirty = bool(rng.random() < 0.7)
        cycle += int(rng.integers(0, 6))
        js, jrot, jfl = _j_record_write(js, jc, jnp.int32(s),
                                        jnp.asarray(dirty), jnp.int32(cycle))
        ts, trot, tfl = tw.record_write(ts, tc, s, dirty, cycle)
        assert bool(trot) == bool(jrot) and int(tfl) == int(jfl), step
        _assert_state_equal(js, ts)
        for sup in range(8):
            assert bool(tw.is_locked(ts, sup, cycle)) == bool(
                _j_is_locked(js, jnp.int32(sup), jnp.int32(cycle)))
    assert (int(js.total_rotates) > 0) == (kw.get("wr_shift") != 32)


def test_record_write_with_dyn_knobs(rng):
    jc, tc = _cfgs(t_mww_cycles=20)
    jd, td = jw.dyn_of(jc), tw.dyn_of(tc, device="cpu")
    js, ts = jw.init_state(jc), tw.init_state(tc, device="cpu")
    for step in range(60):
        s, c = int(rng.integers(0, 8)), step * 2
        js, _, _ = _j_record_write(js, jd, jnp.int32(s), jnp.asarray(True),
                                   jnp.int32(c))
        ts, _, _ = tw.record_write(ts, td, s, True, c)
        _assert_state_equal(js, ts)


def test_record_write_rows_matches_reference(rng):
    jc, tc = _cfgs(wr_shift=32, dc_limit=1 << 30, wc_limit=1 << 30,
                   t_mww_cycles=30)
    js, ts = jw.init_state(jc), tw.init_state(tc, device="cpu")
    for step in range(40):
        sets = rng.permutation(8).astype(np.int32)       # distinct rows
        cycles = (step * 4 + rng.integers(0, 3, 8)).astype(np.int32)
        active = rng.random(8) < 0.6
        dirty = rng.random(8) < 0.5
        js = _j_write_rows(js, jc, jnp.asarray(sets),
                                  jnp.asarray(cycles), jnp.asarray(active),
                                  jnp.asarray(dirty))
        ts = tw.record_write_rows(ts, tc, torch.from_numpy(sets),
                                  torch.from_numpy(cycles),
                                  torch.from_numpy(active),
                                  torch.from_numpy(dirty))
        _assert_state_equal(js, ts)


def test_record_write_rows_inactive_lanes_may_repeat_rows():
    """Inactive lanes are no-ops even when they name an active lane's row
    (the reference's out-of-bounds drop)."""
    jc, tc = _cfgs(wr_shift=32, t_mww_cycles=30)
    sets = np.asarray([2, 2, 5, 2], np.int32)
    cycles = np.asarray([3, 9, 4, 7], np.int32)
    active = np.asarray([False, True, True, False])
    js = jw.record_write_rows(jw.init_state(jc), jc, sets, cycles, active)
    ts = tw.record_write_rows(tw.init_state(tc, device="cpu"), tc,
                              torch.from_numpy(sets), torch.from_numpy(cycles),
                              torch.from_numpy(active))
    _assert_state_equal(js, ts)


def test_window_would_exceed_and_rebase(rng):
    jc, tc = _cfgs(t_mww_cycles=25)
    js, ts = jw.init_state(jc), tw.init_state(tc, device="cpu")
    for step in range(80):
        s = int(rng.integers(0, 8))
        c = step * 3
        js, _, _ = _j_record_write(js, jc, jnp.int32(s), jnp.asarray(True),
                                   jnp.int32(c))
        ts, _, _ = tw.record_write(ts, tc, s, True, c)
        all_sets = np.arange(8, dtype=np.int32)
        np.testing.assert_array_equal(
            tw.window_would_exceed(ts, tc, torch.from_numpy(all_sets),
                                   c).numpy(),
            np.asarray(_j_would_exceed(js, jc, jnp.asarray(all_sets),
                                       jnp.int32(c))))
        if step % 20 == 19:                  # rebase, repeatedly
            js = jw.rebase_clock(js, jw.CLOCK_REBASE_AT)
            ts = tw.rebase_clock(ts, tw.CLOCK_REBASE_AT)
            _assert_state_equal(js, ts)
    assert tw.CLOCK_REBASE_AT == jw.CLOCK_REBASE_AT


@pytest.mark.parametrize("x", [0, 1, 2, 3, 255, 256, 2 ** 30, 2 ** 31 - 1,
                               -1, -2, -(2 ** 31), -12345])
def test_msb_index_exact(x):
    want = int(jw.msb_index(jnp.int32(x)))
    got = tw.msb_index(torch.tensor(x, dtype=torch.int32))
    assert got.dtype == torch.int32 and int(got) == want


def test_msb_index_random(rng):
    x = rng.integers(-(2 ** 31), 2 ** 31, 500).astype(np.int32)
    np.testing.assert_array_equal(
        tw.msb_index(torch.from_numpy(x)).numpy(),
        np.asarray(jw.msb_index(jnp.asarray(x))))


def test_install_decision_and_shard_states():
    d = np.asarray([1, 1, 0, 0])
    r = np.asarray([1, 0, 1, 0])
    ji, jf = jw.install_decision(jnp.asarray(d), jnp.asarray(r))
    ti, tf = tw.install_decision(torch.from_numpy(d), torch.from_numpy(r))
    assert ti.tolist() == np.asarray(ji).tolist()
    assert tf.tolist() == np.asarray(jf).tolist()
    jc, tc = _cfgs()
    _assert_state_equal(jw.concat_states(jw.shard_states(jc, 1)),
                        tw.concat_states(tw.shard_states(tc, 1, device="cpu")))
    assert tw.WALL_HZ == jw.WALL_HZ and tw.CLOCKS == jw.CLOCKS
