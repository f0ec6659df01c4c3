"""Parity: the port's XAM array model (``repro_torch/core/xam.py``) and
address map (``repro_torch/core/geometry.py``) against the JAX package,
over tests/test_xam_core.py's case matrix.  Bits, wear counts, step masks,
match vectors, match indices, coordinates and the float32 search voltages
must be exactly equal, dtype included."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # clean checkout: deterministic-cases fallback
    from _propcheck import given, settings, strategies as st

from _torch_parity import assert_tree_equal
from repro.core import geometry as jg
from repro.core import xam as jx
from repro_torch.core import geometry as tg
from repro_torch.core import xam as tx


def _arrays(bits):
    """The same bit plane as a JAX and a port XamArray (zero wear)."""
    bits = np.asarray(bits, np.int8)
    wear = np.zeros(bits.shape, np.int32)
    return (jx.XamArray(jnp.asarray(bits), jnp.asarray(wear)),
            tx.XamArray(torch.from_numpy(bits), torch.from_numpy(wear)))


def _eq(want, got):
    assert_tree_equal(want, got)


@jax.jit
def _j_searches(arr, key, mask):
    """The reference's three searches in one compile per shape."""
    return (jx.search_voltages(arr.bits, key, mask), jx.search(arr, key, mask),
            jx.search_digital(arr, key, mask))


# ---------------------------------------------------------------------------
# Writes, with their two-step masks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(16, 32), (8, 8), (64, 512)])
def test_write_steps_match(rows, cols, rng):
    j, t = _arrays(rng.integers(0, 2, (rows, cols)))
    for _ in range(6):
        r = int(rng.integers(0, rows))
        row_data = rng.integers(0, 2, cols).astype(np.int8)
        jr = jx.write_row_steps(j, jnp.asarray(r), jnp.asarray(row_data))
        tr = tx.write_row_steps(t, r, torch.from_numpy(row_data))
        for want, got in zip(jr, tr):
            _eq(want, got)
        j, t = jr[0], tr[0]
        c = int(rng.integers(0, cols))
        col_data = rng.integers(0, 2, rows).astype(np.int8)
        jc = jx.write_col_steps(j, jnp.asarray(c), jnp.asarray(col_data))
        tc = tx.write_col_steps(t, c, torch.from_numpy(col_data))
        for want, got in zip(jc, tc):
            _eq(want, got)
        j, t = jc[0], tc[0]
        _eq(jx.read_row(j, jnp.asarray(r)), tx.read_row(t, r))


def test_make_and_set_helpers_match(rng):
    _eq(jx.make_array(16, 32), tx.make_array(16, 32, device="cpu"))
    js, ts = jx.make_set(8, 32), tx.make_set(8, 32, device="cpu")
    _eq(js, ts)
    key = rng.integers(0, 2, 8).astype(np.int8)
    block = rng.integers(0, 2, 32).astype(np.int8)
    js = jx.store_key_colwise(js, jnp.asarray(20), jnp.asarray(key))
    ts = tx.store_key_colwise(ts, 20, torch.from_numpy(key))
    js = jx.pack_block_rowwise(js, jnp.asarray(3), jnp.asarray(block))
    ts = tx.pack_block_rowwise(ts, 3, torch.from_numpy(block))
    _eq(js, ts)


def test_row_col_sequences_and_wear_match(rng):
    """Row-wise and column-wise fills of the same pattern, and repeated
    writes of one line: bits and the full-line wear counts equal."""
    bits = rng.integers(0, 2, (8, 8)).astype(np.int8)
    ja, ta = jx.make_array(8, 8), tx.make_array(8, 8, device="cpu")
    jb, tb = jx.make_array(8, 8), tx.make_array(8, 8, device="cpu")
    for i in range(8):
        ja = jx.write_row(ja, jnp.asarray(i), jnp.asarray(bits[i]))
        ta = tx.write_row(ta, i, torch.from_numpy(bits[i]))
        jb = jx.write_col(jb, jnp.asarray(i), jnp.asarray(bits[:, i]))
        tb = tx.write_col(tb, i, torch.from_numpy(bits[:, i].copy()))
    _eq(ja, ta)
    _eq(jb, tb)
    for _ in range(2):
        ja = jx.write_row(ja, jnp.asarray(1), jnp.zeros(8, jnp.int8))
        ta = tx.write_row(ta, 1, torch.zeros(8, dtype=torch.int8))
    ja = jx.write_col(ja, jnp.asarray(2), jnp.ones(8, jnp.int8))
    ta = tx.write_col(ta, 2, torch.ones(8, dtype=torch.int8))
    _eq(ja, ta)


# ---------------------------------------------------------------------------
# Searches: analog voltages, threshold, digital oracle, set search.
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31), rows=st.integers(1, 64),
       cols=st.integers(1, 64))
def test_search_matches(seed, rows, cols):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rows, cols)).astype(np.int8)
    # Plant a few exact and masked matches so both outcomes occur.
    key = rng.integers(0, 2, rows).astype(np.int8)
    bits[:, ::5] = key[:, None]
    mask = rng.integers(0, 2, rows).astype(np.int8)
    j, t = _arrays(bits)
    jk, jm = jnp.asarray(key), jnp.asarray(mask)
    tk, tm = torch.from_numpy(key), torch.from_numpy(mask)
    _eq(_j_searches(j, jk, jm),
        (tx.search_voltages(t.bits, tk, tm), tx.search(t, tk, tm),
         tx.search_digital(t, tk, tm)))


@pytest.mark.parametrize("n", [0, 1, 2, 8, 64, 512])
def test_ref_s_matches(n):
    _eq(jx.ref_s(jnp.asarray(n)), tx.ref_s(torch.tensor(n)))


def test_set_search_match_register_matches(rng):
    """A stored key found at its column; its complement misses (-1); an
    all-zero mask matches the first column."""
    j, t = jx.make_set(8, 32), tx.make_set(8, 32, device="cpu")
    key = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int8)
    j = jx.store_key_colwise(j, jnp.asarray(20), jnp.asarray(key))
    t = tx.store_key_colwise(t, 20, torch.from_numpy(key))
    rand = np.random.default_rng(3).integers(0, 2, (4, 8)).astype(np.int8)
    for k, m in [(key, np.ones(8, np.int8)), (1 - key, np.ones(8, np.int8)),
                 *zip(rand[:2], rand[2:]), (key, np.zeros(8, np.int8))]:
        want = jx.set_search(j, jnp.asarray(k), jnp.asarray(m))
        got = tx.set_search(t, torch.from_numpy(k), torch.from_numpy(m))
        _eq(want, got)
    assert int(got[1]) == 0


# ---------------------------------------------------------------------------
# Packed plane views.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(8, 2), (64, 512), (32, 33)])
def test_packed_views_match(rows, cols, rng):
    bits = rng.integers(0, 2, (rows, cols)).astype(np.int8)
    jp = jx.packed_view(jnp.asarray(bits))
    tp = tx.packed_view(torch.from_numpy(bits))
    _eq(jp, tp)
    _eq(jx.unpacked_view(jp), tx.unpacked_view(tp))
    assert torch.equal(tx.unpacked_view(tp), torch.from_numpy(bits))


def test_packed_view_rejects_ragged_rows():
    with pytest.raises(ValueError, match="multiple of 8"):
        tx.packed_view(torch.zeros((7, 4), dtype=torch.int8))


# ---------------------------------------------------------------------------
# Address map: geometry, diagonal sets, ports, decompose/compose, Fig. 7.
# ---------------------------------------------------------------------------

def test_geometry_constants_match():
    assert tg.BLOCK_BYTES == jg.BLOCK_BYTES and tg.SET_WAYS == jg.SET_WAYS
    for factor in (1, 64, 256, 10 ** 6):
        j, t = jg.GEOM_8GB.scaled(factor), tg.GEOM_8GB.scaled(factor)
        for name in ("blocks_per_set", "blocks_per_superset",
                     "total_supersets", "total_blocks", "capacity_bytes"):
            assert getattr(t, name) == getattr(j, name), (factor, name)
    assert tg.GEOM_8GB.capacity_bytes == 8 * 1024 ** 3


def test_diagonal_sets_and_ports_match():
    for k in range(8):
        assert tg.subarrays_of_set(k) == jg.subarrays_of_set(k)
        for mode in (False, True):
            assert tg.port_select(k, mode) == jg.port_select(k, mode)
    for i in range(8):
        for j in range(8):
            assert tg.set_of_subarray(i, j) == jg.set_of_subarray(i, j)
    ii = np.repeat(np.arange(8, dtype=np.int32), 8)
    jj = np.tile(np.arange(8, dtype=np.int32), 8)
    _eq(jg.set_of_subarray(jnp.asarray(ii), jnp.asarray(jj)),
        tg.set_of_subarray(torch.from_numpy(ii), torch.from_numpy(jj)))


def _offsets(n_rotates: int):
    jo, to = jg.zero_offsets(), tg.zero_offsets("cpu")
    for _ in range(n_rotates):
        jo, to = jg.apply_rotate(jo), tg.apply_rotate(to)
    return jo, to


@settings(max_examples=40, deadline=None)
@given(addr=st.integers(0, jg.GEOM_8GB.total_blocks - 1))
def test_decompose_compose_match(addr):
    g = jg.GEOM_8GB
    for n_rot in (None, 3, 9):
        jo, to = (None, None) if n_rot is None else _offsets(n_rot)
        jc = jg.decompose(jnp.asarray(addr), g, jo)
        tc = tg.decompose(torch.tensor(addr), tg.GEOM_8GB, to)
        _eq(jc, tc)
        _eq(jg.compose(jc, g), tg.compose(tc, tg.GEOM_8GB))
        assert int(jc.flat_superset(g)) == int(tc.flat_superset(tg.GEOM_8GB))


@pytest.mark.parametrize("n_rotates", [0, 2, 8])
def test_decompose_vector_matches(n_rotates):
    """Every block of a scaled stack at once, with rotated offsets: the
    remap is the same permutation in both packages."""
    g = jg.GEOM_8GB.scaled(256)
    jo, to = _offsets(n_rotates)
    addrs = np.arange(g.total_blocks, dtype=np.int64)
    jc = jg.decompose(jnp.asarray(addrs, jnp.int32), g, jo)
    tc = tg.decompose(torch.from_numpy(addrs), tg.GEOM_8GB.scaled(256), to)
    _eq(jc, tc)
    phys = tg.compose(tc, tg.GEOM_8GB.scaled(256))
    _eq(jg.compose(jc, g), phys)
    assert len(torch.unique(phys)) == g.total_blocks


def test_ram_to_cam_matches():
    g = jg.GEOM_8GB
    banks = np.arange(64, dtype=np.int32)
    for n_cam in (1, 2, 4):
        want = jg.ram_to_cam(jnp.asarray(banks), g, n_cam)
        got = tg.ram_to_cam(torch.from_numpy(banks), tg.GEOM_8GB, n_cam)
        _eq(want, got)
    # Fig. 7's 30 RAM banks land on distinct tag locations.
    got = tg.ram_to_cam(torch.arange(30), tg.GEOM_8GB)
    seen = set(zip(got.bank.tolist(), got.set_.tolist(), got.key_id.tolist()))
    assert len(seen) == 30
