"""Parity: the port's vault controllers (``repro_torch/core/controller.py``)
and the lane-batched §8 wear step against the JAX package, step for step.

The flat-CAM controller replays command sequences (mode toggles, lazy
key/mask push, fresh-match reuse, tracked writes) and the cache engine
install / lookup / invalidate sequences; every state field, output and
command count must be exactly equal after every command.  The lane-batched
forms (a leading lane axis G) are held against ``jax.vmap`` of the
reference's single-state functions, with rotations firing."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal
from repro.core import controller as jc
from repro.core import wear as jw
from repro_torch.core import controller as tc
from repro_torch.core import wear as tw
from repro_torch.pytree import tree_leaves

# One compile per shape keeps the replays fast; the functions are the
# reference's own.
_j = {name: jax.jit(getattr(jc, name)) for name in (
    "cam_data_write", "key_mask_write", "search_read", "cam_row_read",
    "cache_lookup", "cache_install", "cache_invalidate_sets",
    "dirty_set_mask")}


def _bits(word: int, n: int) -> np.ndarray:
    return np.array([(word >> i) & 1 for i in range(n)], np.int8)


# ---------------------------------------------------------------------------
# flat-CAM controller.
# ---------------------------------------------------------------------------

def _flat_pair(n_sets, rows, cols):
    return (jc.init_flat_cam(n_sets, rows, cols),
            tc.init_flat_cam(n_sets, rows, cols, device="cpu"))


def test_flat_cam_scripted_flow_matches():
    """tests/test_controller.py's flows in one replay: the first CAM write
    toggles both latches once, even/odd rows pick key/mask, a search pushes
    key/mask once and a fresh result is reused, a data write invalidates
    the match register, a missing key reads NULL."""
    js, ts = _flat_pair(2, 64, 512)
    full = (1 << 64) - 1
    script = [
        ("cam_data_write", (0, 7, _bits(0x77, 64))),
        ("cam_data_write", (0, 3, _bits(0xAB, 64))),
        ("key_mask_write", (0, _bits(0x77, 64))),
        ("key_mask_write", (1, _bits(full, 64))),
        ("search_read", (0,)),
        ("search_read", (0,)),
        ("cam_data_write", (0, 7, _bits(0x66, 64))),
        ("search_read", (0,)),
        ("key_mask_write", (2, _bits(0xDEAD, 64))),
        ("search_read", (1,)),
        ("cam_row_read", (0, 0)),
    ]
    for name, args in script:
        want = _j[name](js, *[jnp.asarray(a) for a in args])
        got = getattr(tc, name)(ts, *[torch.as_tensor(a) for a in args])
        assert_tree_equal(want, got, name)
        js, ts = want[0], got[0]
    assert int(ts.match_reg) == -1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flat_cam_random_sequence_matches(seed):
    rng = np.random.default_rng(seed)
    n_sets, rows, cols = 3, 16, 32
    js, ts = _flat_pair(n_sets, rows, cols)
    pool = rng.integers(0, 2, (4, rows)).astype(np.int8)  # keys that repeat
    searches = 0
    for _ in range(60):
        op = rng.choice(["cam_data_write", "key_mask_write", "search_read",
                         "cam_row_read"], p=[0.35, 0.2, 0.35, 0.1])
        s = int(rng.integers(0, n_sets))
        if op == "cam_data_write":
            args = (s, int(rng.integers(0, cols)), pool[rng.integers(0, 4)])
        elif op == "key_mask_write":
            value = (pool[rng.integers(0, 4)] if rng.random() < 0.6 else
                     rng.integers(0, 2, rows).astype(np.int8))
            args = (int(rng.integers(0, 4)), value)
        elif op == "search_read":
            args = (s,)
        else:
            args = (s, int(rng.integers(0, rows)))
        want = _j[op](js, *[jnp.asarray(a) for a in args])
        got = getattr(tc, op)(ts, *[torch.as_tensor(a) for a in args])
        assert_tree_equal(want, got, op)
        js, ts = want[0], got[0]
        if op == "search_read":
            searches += int(got[2].searches)
    assert searches > 0


def test_cam_data_write_tracked_matches(rng):
    """The tracked write charges the controller and records the §8 write
    in one call; DC rotations fire within the replay."""
    cfg = dict(n_supersets=4, dc_limit=3, t_mww_cycles=40,
               blocks_per_superset=2, m_writes=2)
    jcfg, tcfg = jw.WearConfig(**cfg), tw.WearConfig(**cfg)
    js, ts = _flat_pair(2, 16, 32)
    jws, tws = jw.init_state(jcfg), tw.init_state(tcfg, device="cpu")
    step = jax.jit(jc.cam_data_write_tracked, static_argnums=(2,))
    rotations = 0
    for cycle in range(40):
        s, col = int(rng.integers(0, 2)), int(rng.integers(0, 32))
        key = rng.integers(0, 2, 16).astype(np.int8)
        superset = int(rng.integers(0, 4))
        want = step(js, jws, jcfg, jnp.asarray(s), jnp.asarray(col),
                    jnp.asarray(key), superset, cycle)
        got = tc.cam_data_write_tracked(ts, tws, tcfg, s, col,
                                        torch.from_numpy(key), superset,
                                        cycle)
        assert_tree_equal(want, got, f"cycle {cycle}")
        js, jws, ts, tws = want[0], want[1], got[0], got[1]
        rotations += int(got[2])
    assert rotations > 0


# ---------------------------------------------------------------------------
# Cache-mode engine, one state.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sets,ways", [(4, 8), (1, 4), (3, 6)])
def test_cache_sequence_matches(n_sets, ways, rng):
    js = jc.init_cache(n_sets, ways)
    ts = tc.init_cache(n_sets, ways, device="cpu")
    assert_tree_equal(js, ts)
    replacements = 0          # installs into a set with no invalid way
    for _ in range(80):
        s = int(rng.integers(0, n_sets))
        tag = int(rng.integers(0, 3 * ways))
        assert_tree_equal(_j["cache_lookup"](js, jnp.asarray(s),
                                             jnp.asarray(tag)),
                          tc.cache_lookup(ts, s, tag), "lookup")
        r = rng.random()
        if r < 0.7:
            dirty = bool(rng.random() < 0.5)
            replacements += int(ts.valid[s].all())
            want = _j["cache_install"](js, jnp.asarray(s), jnp.asarray(tag),
                                       jnp.asarray(dirty))
            got = tc.cache_install(ts, s, tag, dirty)
            assert_tree_equal(want, got, "install")
            js, ts = want[0], got[0]
        elif r < 0.8:
            mask = rng.random(n_sets) < 0.5
            assert_tree_equal(_j["dirty_set_mask"](js),
                              tc.dirty_set_mask(ts), "dirty_set_mask")
            want = _j["cache_invalidate_sets"](js, jnp.asarray(mask))
            got = tc.cache_invalidate_sets(ts, torch.from_numpy(mask))
            assert_tree_equal(want, got, "invalidate")
            js, ts = want[0], got[0]
    assert replacements > 0


def test_cache_install_all_dirty_evicts_at_counter():
    """A full set of dirty lines: no invalid or clean way, so the way at
    the counter is evicted dirty (both packages agree on which)."""
    js, ts = jc.init_cache(1, 4), tc.init_cache(1, 4, device="cpu")
    for t in range(6):
        want = _j["cache_install"](js, jnp.asarray(0), jnp.asarray(t + 1),
                                   jnp.asarray(True))
        got = tc.cache_install(ts, 0, t + 1, True)
        assert_tree_equal(want, got)
        js, ts = want[0], got[0]
    assert bool(got[1])


# ---------------------------------------------------------------------------
# Lane-batched forms against jax.vmap of the single-state functions.
# ---------------------------------------------------------------------------

G = 6


def _stack_np(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def test_cache_lanes_match_vmap(rng):
    n_sets, ways = 4, 8
    js = _stack_np([jc.init_cache(n_sets, ways)] * G)
    ts = tc.init_cache(n_sets, ways, device="cpu", lanes=G)
    assert_tree_equal(js, ts)
    lookup = jax.jit(jax.vmap(jc.cache_lookup))
    install = jax.jit(jax.vmap(jc.cache_install))
    invalidate = jax.jit(jax.vmap(jc.cache_invalidate_sets))
    dirty_mask = jax.jit(jax.vmap(jc.dirty_set_mask))
    for k in range(60):
        s = rng.integers(0, n_sets, G).astype(np.int32)
        tag = rng.integers(0, 3 * ways, G).astype(np.int32)
        dirty = rng.random(G) < 0.5
        assert_tree_equal(lookup(js, s, tag),
                          tc.cache_lookup(ts, torch.from_numpy(s),
                                          torch.from_numpy(tag)))
        want = install(js, s, tag, dirty)
        got = tc.cache_install(ts, torch.from_numpy(s), torch.from_numpy(tag),
                               torch.from_numpy(dirty))
        assert_tree_equal(want, got, f"install {k}")
        js, ts = want[0], got[0]
        if k % 10 == 9:
            mask = rng.random((G, n_sets)) < 0.5
            assert_tree_equal(dirty_mask(js), tc.dirty_set_mask(ts))
            want = invalidate(js, mask)
            got = tc.cache_invalidate_sets(ts, torch.from_numpy(mask))
            assert_tree_equal(want, got, f"invalidate {k}")
            js, ts = want[0], got[0]


def _lane_knobs():
    """Per-lane knobs: DC rotations, WR rotations, tight and loose t_MWW
    windows, and one lane whose rotate signals never fire."""
    dc = np.array([3, 1 << 30, 5, 2, 1 << 30, 4], np.int32)
    wr = np.array([9, 2, 9, 3, 32, 9], np.int32)
    budget = np.array([4, 6, 2, 8, 3, 5], np.int32)
    window = np.array([30, 50, 20, 1, 0, 70], np.int32)
    wc = np.full(G, 1 << 22, np.int32)
    return dict(window_write_budget=budget, dc_limit=dc, wc_limit=wc,
                wr_shift=wr, t_mww_cycles=window)


def test_record_write_lanes_match_vmap(rng):
    n_sup = 8
    knobs = _lane_knobs()
    jdyn = jw.WearDyn(**{k: jnp.asarray(v) for k, v in knobs.items()})
    tdyn = tw.WearDyn(**{k: torch.from_numpy(v) for k, v in knobs.items()})
    js = _stack_np([jw.init_state(jw.WearConfig(n_supersets=n_sup))] * G)
    ts = tw.init_state(tw.WearConfig(n_supersets=n_sup), device="cpu",
                       lanes=G)
    assert_tree_equal(js, ts)
    record = jax.jit(jax.vmap(jw.record_write))
    locked = jax.jit(jax.vmap(jw.is_locked))
    rotations = 0
    cycle = np.zeros(G, np.int32)
    for k in range(150):
        s = rng.integers(0, n_sup, G).astype(np.int32)
        dirty = rng.random(G) < 0.6
        cycle = cycle + rng.integers(0, 3, G).astype(np.int32)
        assert_tree_equal(locked(js, s, cycle),
                          tw.is_locked(ts, torch.from_numpy(s),
                                       torch.from_numpy(cycle)))
        want = record(js, jdyn, s, dirty, cycle)
        got = tw.record_write(ts, tdyn, torch.from_numpy(s),
                              torch.from_numpy(dirty), torch.from_numpy(cycle))
        assert_tree_equal(want, got, f"write {k}")
        js, ts = want[0], got[0]
        rotations += int(got[1].sum())
    assert rotations > 0
    assert int(ts.total_rotates[4]) == 0      # the lane with rotation off
    assert int((ts.locked_until > 0).sum()) > 0


def test_record_write_single_state_unchanged_by_lanes(rng):
    """The single state goes through the same code as lane 0 of a batch."""
    cfg = tw.WearConfig(n_supersets=4, dc_limit=3, t_mww_cycles=10,
                        blocks_per_superset=1, m_writes=2)
    one = tw.init_state(cfg, device="cpu")
    many = tw.init_state(cfg, device="cpu", lanes=1)
    for cycle in range(30):
        s, d = int(rng.integers(0, 4)), bool(rng.random() < 0.5)
        one, rot1, fl1 = tw.record_write(one, cfg, s, d, cycle)
        many, rotg, flg = tw.record_write(many, cfg, torch.tensor([s]),
                                          torch.tensor([d]),
                                          torch.tensor([cycle]))
        assert bool(rot1) == bool(rotg[0]) and int(fl1) == int(flg[0])
    for a, b in zip(tree_leaves(one), tree_leaves(many)):
        assert torch.equal(a, b[0])
