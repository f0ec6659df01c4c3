"""Parity: the port's logical index shards and its two fanout oracles
against the JAX reference — the cases of tests/test_kv_index_sharded.py
and tests/test_kv_index_differential.py.

Every case runs the reference and the port through the same seeded
schedule and holds the port's whole index state (global planes,
``fp_of``, ``read_after``, ``set_writes``, counters, wear state, stats,
shadow map and ``wear_report``) to the reference's exactly after every
op.  On one device the reference's ``"auto"`` index collapses every
shard count to one partition, as the port's does; ``"fanout"`` keeps one
partition per logical shard in both.  Across shard counts and across
the two dispatches, the port's states must also equal each other.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import fingerprint_blocks
from repro.kernels.xam_search import ops as j_ops
from repro.serve import admit_queue as j_aq
from repro.serve import kv_index as j_kv
from repro_torch.core import geometry as t_geo
from repro_torch.kernels.common import unpack_bits_np
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.serve import admit_queue as t_aq
from repro_torch.serve import kv_index as t_kv
from test_torch_kv_index import _assert_index_equal

SHARD_COUNTS = (1, 2, 4)
CHUNK = t_kv.CHUNK_TOKENS


def _cfg(n_shards: int, **kw) -> dict:
    base = dict(n_sets=8, set_ways=8, admit_after_reads=1, m_writes=2,
                window_ops=256, rotate_every=1 << 30, n_shards=n_shards)
    base.update(kw)
    return base


class _Pair:
    """One reference index and one port index on the same config."""

    def __init__(self, n_shards: int, dispatch: str = "auto", **kw):
        cfg = _cfg(n_shards, **kw)
        self.j = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**cfg),
                                     dispatch=dispatch)
        self.t = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**cfg),
                                     dispatch=dispatch, device="cpu")

    def admit_fps(self, fps):
        self.j.admit_fps(fps)
        self.t.admit_fps(fps)

    def lookup(self, toks):
        got, want = self.t.lookup(toks), self.j.lookup(toks)
        np.testing.assert_array_equal(got, want)
        return got

    def rotate(self):
        self.j._rotate()
        self.t._rotate()

    def check(self):
        _assert_index_equal(self.j, self.t)


def _state(idx: t_kv.MonarchKVIndex) -> dict:
    """The port's global state, planes unpacked to bits."""
    bits = idx.bits.cpu().numpy()
    if bits.dtype == np.uint8:
        bits = unpack_bits_np(bits, idx.cfg.key_bits, axis=1)
    return dict(
        slot_of=dict(idx.slot_of), first_touch=dict(idx.first_touch),
        offset=idx.offset, bits=bits, valid=idx.valid.cpu().numpy(),
        fp_of=idx.fp_of.cpu().numpy(),
        read_after=idx.read_after.cpu().numpy(),
        counter=idx.counter.cpu().numpy(), writes=idx.write_distribution(),
        window_writes=idx.wear_state.window_writes.cpu().numpy(),
        ops=idx.ops_total, report=idx.wear_report(),
        stats=(idx.stats.admissions, idx.stats.admission_skips,
               idx.stats.throttled, idx.stats.evictions,
               idx.stats.chunk_hits, idx.stats.chunk_misses,
               idx.stats.rotations))


def _assert_same(a: dict, b: dict, msg: str):
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{msg}: {key}")
        else:
            assert a[key] == b[key], (msg, key)


def _schedule(rng, pairs, steps: int, admit_p=0.6, reoffer_p=0.4,
              lookup_p=0.9):
    """The reference suites' randomized admit / re-offer / lookup /
    rotate schedule, every pair checked after every op and the port's
    indexes held to each other."""
    for step in range(steps):
        toks = rng.integers(1, 600, (2, 6 * CHUNK)).astype(np.int32)
        op = rng.random()
        if op < admit_p:
            fps = np.unique(fingerprint_blocks(toks, CHUNK).reshape(-1))
            for p in pairs:
                p.admit_fps(fps)
            if op < reoffer_p:            # re-offer crosses the gate
                for p in pairs:
                    p.admit_fps(fps)
        elif op < lookup_p:
            hits = [p.lookup(toks) for p in pairs]
            for h in hits[1:]:
                np.testing.assert_array_equal(hits[0], h)
        else:
            for p in pairs:
                p.rotate()
        for p in pairs:
            p.check()
        ref = _state(pairs[0].t)
        for p in pairs[1:]:
            _assert_same(ref, _state(p.t), f"step {step}")


# ---------------------------------------------------------------------------
# tests/test_kv_index_sharded.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_shard_count_invariance(seed):
    """Seeded admit/lookup/rotate schedules at every shard count: the
    port equals the reference, and every shard count equals the others
    (hits, installs, wear reports)."""
    rng = np.random.default_rng(seed)
    pairs = [_Pair(n) for n in SHARD_COUNTS]
    _schedule(rng, pairs, 8)
    s = pairs[0].t.stats
    assert s.admissions > 0 and s.admission_skips > 0


@pytest.mark.parametrize("dispatch", ["auto", "fanout"])
def test_shard_invariance_under_eviction_and_throttle_pressure(dispatch):
    """Tiny sets force evictions, a tight window throttles, and a
    rotation after every batch moves sets across shard edges."""
    pairs = [_Pair(n, dispatch, set_ways=4, admit_after_reads=0,
                   m_writes=1, window_ops=64) for n in SHARD_COUNTS]
    for chunk in np.arange(1, 129, dtype=np.uint32).reshape(8, 16):
        for p in pairs:
            p.admit_fps(chunk)
            p.rotate()
            p.check()
        ref = _state(pairs[0].t)
        for p in pairs[1:]:
            _assert_same(ref, _state(p.t), f"heavy trace {dispatch}")
    s = pairs[0].t.stats
    assert s.evictions > 0 and s.throttled > 0 and s.rotations == 8


def test_sharded_state_shapes_and_ownership():
    """One partition under "auto" on one device, one per logical shard
    under "fanout"; the global views concatenate in set order."""
    idx = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**_cfg(4)), device="cpu")
    ref = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**_cfg(4)))
    assert idx.sets_per_shard == ref.sets_per_shard == 2
    assert idx.n_parts == ref.n_parts == 1
    assert len(idx._bits) == 1 and idx.bits is idx._bits[0]
    fan = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**_cfg(4)),
                              dispatch="fanout", device="cpu")
    assert fan.n_parts == 4 and fan.sets_per_part == 2
    for k in range(4):
        assert fan._bits[k].shape == (2, fan.cfg.key_bits, fan.cfg.set_ways)
        assert fan._wear_states[k].window_writes.shape == (2,)
        assert fan._counters[k].shape == (2,)
    assert tuple(fan.valid.shape) == (8, fan.cfg.set_ways)
    assert tuple(fan.wear_state.window_writes.shape) == (8,)
    shard, local = t_geo.shard_of_set(torch.arange(8), 8, 4)
    assert shard.tolist() == [k // 2 for k in range(8)]
    assert local.tolist() == [k % 2 for k in range(8)]
    # assigning a global view re-splits it into the partitions
    fan.valid = torch.arange(8 * 8, dtype=torch.int8).reshape(8, 8)
    assert fan._valid[3][1, 0] == 7 * 8


def test_shard_count_must_divide_sets():
    for mod, kw in ((j_kv, {}), (t_kv, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.MonarchKVIndex(mod.KVIndexConfig(n_sets=8, n_shards=3), **kw)


def test_lookup_is_single_dispatch_at_every_shard_count(rng):
    """One multi-set launch per lookup at every shard count under
    "auto"; one per shard holding queries under "fanout"."""
    toks = rng.integers(1, 50_000, (4, 256)).astype(np.int32)
    for n_shards in SHARD_COUNTS:
        idx = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(
            **_cfg(n_shards, admit_after_reads=0)), device="cpu")
        before, s_before = t_ops.LAUNCH_COUNT, idx.stats.searches
        idx.lookup(toks)
        assert t_ops.LAUNCH_COUNT == before + 1, n_shards
        assert idx.stats.searches == s_before + 1
    fan = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(
        **_cfg(4, admit_after_reads=0)), dispatch="fanout", device="cpu")
    before = t_ops.LAUNCH_COUNT
    fan.lookup(toks)                   # 64 chunks: all four shards hit
    assert t_ops.LAUNCH_COUNT == before + 4
    assert fan.stats.searches == 4


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_queue_flush_matches_inline_admission(rng, background, n_shards):
    """submit*; flush == the same admit_fps calls inline, in the port as
    in the reference, and the port's drained index equals the
    reference's."""
    cfg = _cfg(n_shards, n_sets=4, set_ways=16, admit_after_reads=1,
               m_writes=1 << 20, window_ops=1 << 30)
    inline = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**cfg), device="cpu")
    queued = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**cfg), device="cpu")
    j_queued = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**cfg))
    q = t_aq.AdmitQueue(queued, background=background)
    jq = j_aq.AdmitQueue(j_queued, background=background)
    batches = [np.unique(rng.integers(1, 400, 24).astype(np.uint32))
               for _ in range(6)]
    batches += batches[:3]
    for fps in batches:
        inline.admit_fps(fps)
        q.submit(fps)
        jq.submit(fps)
    q.flush()
    jq.flush()
    _assert_same(_state(inline), _state(queued), "queue vs inline")
    _assert_index_equal(j_queued, queued)
    assert q.stats.batches == jq.stats.batches == len(batches)
    q.close()
    jq.close()


# ---------------------------------------------------------------------------
# tests/test_kv_index_differential.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_step_trace(seed, n_shards, plane_format):
    """The auto index and the fanout oracle through one randomized
    schedule: both equal the reference's twins, and each other, after
    every op; every trace crosses a rotation."""
    rng = np.random.default_rng(seed)
    pairs = [_Pair(n_shards, d, plane_format=plane_format)
             for d in ("auto", "fanout")]
    _schedule(rng, pairs, 10, admit_p=0.55, reoffer_p=0.35,
              lookup_p=0.85)
    for p in pairs:
        p.rotate()
        p.check()
    _assert_same(_state(pairs[0].t), _state(pairs[1].t), "final rotate")
    assert pairs[0].t.stats.admissions > 0


@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_differential_boundary_straddle_after_rotation(n_shards,
                                                       plane_format):
    """Residents in every shard-edge set, pushed across the edges by
    repeated set+7 rotations: residency survives on both paths, and the
    one-launch search, the per-shard search and the reference agree."""
    pairs = [_Pair(n_shards, d, admit_after_reads=0, set_ways=16,
                   plane_format=plane_format) for d in ("auto", "fanout")]
    auto, fan = pairs[0].t, pairs[1].t
    n_sets = auto.cfg.n_sets
    s_part = n_sets // n_shards
    fps = np.arange(1, 257, dtype=np.uint32)
    for p in pairs:
        p.admit_fps(fps)
    edge = {b for k in range(n_shards)
            for b in (k * s_part, (k + 1) * s_part - 1)}
    assert {int(s) for s, _ in auto.slot_of.values()} >= edge
    key_bits = t_ops.words_to_bits_np(fps, auto.cfg.key_bits)
    for rot in range(3):
        for p in pairs:
            p.rotate()
            p.check()
        _assert_same(_state(auto), _state(fan), f"rot {rot}")
        sets = auto._set_of(fps)
        ways = t_ops.xam_search_multiset(key_bits, sets, auto._bits[0],
                                         auto._valid[0])
        resident = np.asarray([int(f) in auto.slot_of for f in fps])
        np.testing.assert_array_equal(ways >= 0, resident)
        got = t_ops.xam_search_multiset_sharded(key_bits, sets, fan._bits,
                                                fan._valid)
        np.testing.assert_array_equal(got, ways)
        j = pairs[1].j
        want = j_ops.xam_search_multiset_sharded(key_bits, sets, j._bits,
                                                 j._valid)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert auto.stats.rotations == 3


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_admission_is_single_dispatch_at_every_shard_count(n_shards):
    """One admission dispatch per batch under "auto" at every shard
    count; one per partition holding candidates under "fanout"."""
    pairs = [_Pair(n_shards, d, admit_after_reads=0)
             for d in ("auto", "fanout")]
    auto, fan = pairs[0].t, pairs[1].t
    rng = np.random.default_rng(0)
    for _ in range(4):
        fps = np.unique(rng.integers(1, 3000, 24).astype(np.uint32))
        before = t_ops.ADMIT_LAUNCH_COUNT
        pairs[0].admit_fps(fps)
        assert t_ops.ADMIT_LAUNCH_COUNT == before + 1
        before = t_ops.ADMIT_LAUNCH_COUNT
        pairs[1].admit_fps(fps)
        want = len(np.unique(fan._set_of(fps) // fan.sets_per_part))
        assert t_ops.ADMIT_LAUNCH_COUNT == before + want
        for p in pairs:
            p.check()
    assert auto.stats.admit_calls == 4
    _assert_same(_state(auto), _state(fan), f"n_shards={n_shards}")


@pytest.mark.parametrize("clock", ["ops", "wall"])
def test_fanout_admission_with_rebased_and_wall_clocks(clock):
    """The fanout scan stamps candidates as the reference does: by
    global batch position on the op clock across a clock rebase, one
    host stamp per batch on the wall clock."""
    t = [100.0]
    kw = dict(n_sets=8, set_ways=4, admit_after_reads=0, m_writes=1,
              window_ops=40 if clock == "ops" else 300, clock=clock,
              rotate_every=1 << 30, n_shards=4)
    j = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**kw), dispatch="fanout",
                            now_fn=lambda: t[0])
    p = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(**kw), dispatch="fanout",
                            now_fn=lambda: t[0], device="cpu")
    if clock == "ops":
        j.ops_total = p.ops_total = j_kv.wear.CLOCK_REBASE_AT - 20
    rng = np.random.default_rng(4)
    for _ in range(6):
        t[0] += 1e-4
        fps = np.unique(rng.integers(1, 200, 20).astype(np.uint32))
        j.admit_fps(fps)
        p.admit_fps(fps)
        _assert_index_equal(j, p)
    assert p.stats.throttled > 0 and p.stats.evictions > 0


def test_sharded_search_matches_reference_per_shard(rng):
    """``xam_search_multiset_sharded`` against the reference's, over
    random shard planes with empty shards and repeated sets."""
    n_shards, s_loc, r, c = 4, 3, 32, 24
    planes = rng.integers(0, 2, (n_shards, s_loc, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_shards, s_loc, c)).astype(np.int8)
    sets = rng.choice([0, 1, 2, 4, 6, 8], 90)       # shard 3 holds none
    keys = planes.reshape(-1, r, c)[sets, :, rng.integers(0, c, 90)]
    keys[::7] ^= 1                                   # some misses
    want = j_ops.xam_search_multiset_sharded(
        keys, sets, [jnp.asarray(p) for p in planes],
        [jnp.asarray(v) for v in valid])
    before = t_ops.LAUNCH_COUNT
    got = t_ops.xam_search_multiset_sharded(
        keys, sets, [torch.from_numpy(p) for p in planes],
        [torch.from_numpy(v) for v in valid])
    assert t_ops.LAUNCH_COUNT == before + 3
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got >= 0).any() and (got < 0).any()


def test_stats_fields_match_reference():
    """The port's stats carry the reference's fields."""
    assert ([f.name for f in dataclasses.fields(t_kv.KVIndexStats)]
            == [f.name for f in dataclasses.fields(j_kv.KVIndexStats)])
