"""Parity: the port's host-side functions against the JAX package's, with
exact equality (hashing, bit packing, grouping layouts, timing math,
lifetime-derived windows and every ArchConfig field)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import geometry as j_geo
from repro.core import lifetime as j_life
from repro.core import timing as j_timing
from repro.data import pipeline as j_pipe
from repro.kernels import common as j_common
from repro.kernels.xam_search import ops as j_ops
from repro.serve import kv_index as j_kv
from repro_torch import configs as t_configs
from repro_torch.core import geometry as t_geo
from repro_torch.core import lifetime as t_life
from repro_torch.core import timing as t_timing
from repro_torch.core import wear as t_wear
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import common as t_common
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.models import transformer as t_tf
from repro_torch.serve import kv_index as t_kv


def _eq(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_murmur3(rng):
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.uint32)
    _eq(t_pipe.murmur3_np(x), j_pipe.murmur3_np(x))
    got = t_pipe.murmur3_fmix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_pipe.murmur3_fmix32(x)))


@pytest.mark.parametrize("fn", ["fingerprint_blocks",
                                "prefix_fingerprint_blocks"])
@pytest.mark.parametrize("s", [15, 16, 48, 61])
def test_fingerprint_schemes(fn, s, rng):
    toks = rng.integers(0, 64000, (3, s)).astype(np.int32)
    _eq(getattr(t_pipe, fn)(toks), getattr(j_pipe, fn)(toks))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_unpack_bits(axis, rng):
    bits = rng.integers(0, 2, (16, 24, 8)).astype(np.int8)
    _eq(t_common.pack_bits_np(bits, axis), j_common.pack_bits_np(bits, axis))
    packed = j_common.pack_bits_np(bits, axis)
    _eq(t_common.unpack_bits_np(packed, axis=axis),
        j_common.unpack_bits_np(packed, axis=axis))
    with pytest.raises(ValueError):
        t_common.pack_bits_np(bits[:, :, :5], -1)


def test_plane_formats(monkeypatch):
    for fmt in ("int8", "packed8"):
        assert t_common.resolve_plane_format(fmt) == fmt
    with pytest.raises(ValueError, match=t_common.PLANE_FORMAT_ENV):
        t_common.resolve_plane_format("int4")
    monkeypatch.setenv(t_common.PLANE_FORMAT_ENV, "packed8")
    assert t_common.resolve_plane_format(None) == "packed8"
    assert t_common.plane_format_of(torch.zeros(1, dtype=torch.uint8)) == \
        "packed8"
    assert t_common.plane_format_of(torch.zeros(1, dtype=torch.int8)) == "int8"
    with pytest.raises(ValueError):
        t_common.plane_format_of(torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("n_sets,n_shards", [(8, 1), (8, 4), (32, 2)])
def test_shard_arithmetic(n_sets, n_shards):
    assert (t_geo.sets_per_shard(n_sets, n_shards)
            == j_geo.sets_per_shard(n_sets, n_shards))
    for k in range(n_shards):
        assert (t_geo.shard_set_slice(k, n_sets, n_shards)
                == j_geo.shard_set_slice(k, n_sets, n_shards))
    with pytest.raises(ValueError):
        t_geo.sets_per_shard(n_sets, 3)


@pytest.mark.parametrize("n_sets,n_shards", [(8, 1), (8, 2), (8, 4),
                                              (32, 8)])
def test_shard_of_set(n_sets, n_shards):
    ids = np.arange(n_sets)
    want = j_geo.shard_of_set(ids, n_sets, n_shards)
    got = t_geo.shard_of_set(torch.arange(n_sets), n_sets, n_shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _eq(t_geo.shard_of_set(ids, n_sets, n_shards), want)
    with pytest.raises(ValueError):
        t_geo.shard_of_set(ids, n_sets, 3)


@pytest.mark.parametrize("n_sets,n_parts", [(8, 1), (8, 2), (8, 4),
                                            (32, 4), (30, 5)])
def test_shard_roll_plan(n_sets, n_parts):
    """Every shift in (0, n_sets): the same plan, and the plan moves the
    rows as the global roll does."""
    for shift in range(1, n_sets):
        plan = t_geo.shard_roll_plan(shift, n_sets, n_parts)
        assert plan == j_geo.shard_roll_plan(shift, n_sets, n_parts)
        q, r, low, high = plan
        s_loc = n_sets // n_parts
        src = np.arange(n_sets).reshape(n_parts, s_loc)
        new = np.empty_like(src)
        for j in range(n_parts):
            new[(j + q) % n_parts, r:] = src[j, :s_loc - r]
            if r:
                new[(j + q + 1) % n_parts, :r] = src[j, s_loc - r:]
        np.testing.assert_array_equal(new.reshape(-1),
                                      np.roll(np.arange(n_sets), shift))
        assert (low is None) == (q % n_parts == 0)
    for bad in (0, n_sets):
        with pytest.raises(ValueError):
            t_geo.shard_roll_plan(bad, n_sets, n_parts)


@pytest.mark.parametrize("n_q,n_sets,n_parts,block_q", [
    (0, 8, 2, 16), (3, 8, 2, 4), (130, 8, 4, 16), (300, 32, 4, 64),
    (64, 8, 1, 16)])
def test_group_queries_by_set_stacked(n_q, n_sets, n_parts, block_q, rng):
    sets = rng.integers(0, n_sets, n_q)
    _eq(t_ops.group_queries_by_set_stacked(sets, n_sets, n_parts, block_q),
        j_ops.group_queries_by_set_stacked(sets, n_sets, n_parts, block_q))


def test_rotary_offsets():
    j, t = j_geo.zero_offsets(), t_geo.zero_offsets("cpu")
    for _ in range(17):
        j, t = j_geo.apply_rotate(j), t_geo.apply_rotate(t)
        for f in ("vault", "bank", "superset", "set_", "rotate_count"):
            assert int(getattr(t, f)) == int(getattr(j, f))
            assert getattr(t, f).dtype == torch.int32


@pytest.mark.parametrize("n_bits", [4, 16, 24, 32])
def test_words_to_bits(n_bits, rng):
    w = rng.integers(0, 2 ** 32, 50, dtype=np.uint32)
    _eq(t_ops.words_to_bits_np(w, n_bits), j_ops.words_to_bits_np(w, n_bits))


@pytest.mark.parametrize("n_q,n_sets,block_q", [
    (0, 4, 16), (1, 1, 16), (7, 3, 16), (130, 8, 16), (300, 32, 64)])
def test_group_queries_by_set(n_q, n_sets, block_q, rng):
    sets = rng.integers(0, n_sets, n_q)
    _eq(t_ops.group_queries_by_set(sets, n_sets, block_q),
        j_ops.group_queries_by_set(sets, n_sets, block_q))


@pytest.mark.parametrize("n_q,n_sets,block_q", [(1, 1, 16), (130, 8, 16),
                                                (300, 32, 64)])
def test_pack_multiset_batch_matches_grouping(n_q, n_sets, block_q, rng):
    """The launch layout: each key at its slot with a full mask, every pad
    row masked out, and exactly the grouping's live blocks marked live."""
    sets = rng.integers(0, n_sets, n_q)
    bits = rng.integers(0, 2, (n_q, 24)).astype(np.int8)
    keys, masks, block_sets, live, slot = t_ops.pack_multiset_batch(
        bits, sets, n_sets, block_q)
    j_slot, j_bs, padded_q, n_blocks = j_ops.group_queries_by_set(
        sets, n_sets, block_q)
    _eq((slot, block_sets), (j_slot, j_bs))
    assert keys.shape == masks.shape == (padded_q, 24)
    np.testing.assert_array_equal(keys[slot], bits)
    pad = np.ones(padded_q, bool)
    pad[slot] = False
    assert (masks[slot] == 1).all() and not masks[pad].any()
    assert not keys[pad].any()
    assert live.dtype == np.int32
    assert live.tolist() == [1] * n_blocks + [0] * (len(j_bs) - n_blocks)


_WEAR_CFG = dict(n_supersets=4)


@pytest.mark.parametrize("make", [
    lambda: t_geo.zero_offsets().set_,
    lambda: t_tf.init_cache(t_configs.get_arch("yi-9b").reduced(), 1,
                            16)["groups"]["b0"]["k"],
    lambda: t_wear.init_state(t_wear.WearConfig(**_WEAR_CFG)).window_start,
    lambda: t_wear.dyn_of(t_wear.WearConfig(**_WEAR_CFG)).dc_limit,
    lambda: t_wear.shard_states(t_wear.WearConfig(**_WEAR_CFG),
                                1)[0].window_start,
], ids=["zero_offsets", "init_cache", "init_state", "dyn_of",
        "shard_states"])
def test_state_constructors_default_to_the_card(make):
    """No device argument means CUDA: without a card that raises instead
    of building tensors on the CPU."""
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("n_q,n_sets", [(0, 4), (1, 8), (9, 4), (64, 8),
                                        (200, 32)])
def test_group_admits_stacked(n_q, n_sets, rng):
    sets = rng.integers(0, n_sets, n_q)
    _eq(t_ops.group_admits_stacked(sets, n_sets, 1),
        j_ops.group_admits_stacked(sets, n_sets, 1))


@pytest.mark.parametrize("n,lo", [(0, 4), (1, 4), (5, 4), (17, 1), (64, 8)])
def test_bucket_pow2(n, lo):
    assert t_common.bucket_pow2(n, lo) == j_common.bucket_pow2(n, lo)


def test_block_q_cold_fallback():
    """The port's block width is the reference's cold autotune fallback."""
    for n in (1, 255, 256, 4096):
        assert t_ops._pick_block_q(n, None) == (64 if n >= 256 else 16)
    assert t_ops._pick_block_q(5, 32) == 32


def test_timing_math():
    for args in [(3, 10 * t_timing.SECONDS_PER_YEAR, 1e8), (1, 1e6, 1e4)]:
        assert t_timing.t_mww_seconds(*args) == j_timing.t_mww_seconds(*args)
    assert t_timing.CPU_HZ == j_timing.CPU_HZ
    for name in ("TECH_TIMING", "TABLE1"):
        as_dicts = lambda m: {k: dataclasses.asdict(v)
                              for k, v in getattr(m, name).items()}
        assert as_dicts(t_timing) == as_dicts(j_timing)


@pytest.mark.parametrize("clock", ["ops", "wall"])
def test_with_lifetime(clock):
    t = t_kv.KVIndexConfig.with_lifetime(t_life_years=10.0, clock=clock)
    j = j_kv.KVIndexConfig.with_lifetime(t_life_years=10.0, clock=clock)
    assert t.window_ops == j.window_ops == 9467280
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("rot", [0, 1, 5])
def test_lifetime_estimate(rot, rng):
    w = rng.integers(0, 50, 16)
    assert (dataclasses.asdict(t_life.estimate_from_ops(w, 5000, rot))
            == dataclasses.asdict(j_life.estimate_from_ops(w, 5000, rot)))


@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_arch_configs(arch):
    j = j_configs.get_arch(arch)
    t = t_configs.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.layer_pattern() == j.layer_pattern()
    assert t.scan_groups() == j.scan_groups()


def test_yi_9b_full_width():
    cfg = t_configs.get_arch("yi-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == (
        48, 4096, 32, 4, 128, 11008, 64000)
