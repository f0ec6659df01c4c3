"""Parity: the port's hopscotch window lookup (its plain version, which the
wrapper runs for CPU tensors) and its device insert path against the JAX
``kernels/hopscotch`` ops, with exact equality, over tests/test_kernels.py's
hopscotch matrices and random insert schedules.  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py`` and by
tests/test_torch_gpu.py."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hopscotch import ops as j_ops
from repro.kernels.hopscotch.ref import hopscotch_lookup_ref
from repro_torch.kernels.edge_cases import hop_edge_case
from repro_torch.kernels.hopscotch import ops as t_ops
from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain


def _planes(t_lo, t_hi):
    return (torch.from_numpy(t_ops.as_i32_bits(t_lo)),
            torch.from_numpy(t_ops.as_i32_bits(t_hi)))


def _both(t_lo, t_hi, homes, q_lo, q_hi, window, *, kernel=True):
    """The port's wrapper (CPU) and the JAX op (Pallas interpret mode, or
    its ref oracle for the larger matrices) on the same inputs."""
    got = t_ops.hopscotch_lookup(*_planes(t_lo, t_hi), homes, q_lo, q_hi,
                                 window=window)
    assert got.dtype == torch.int32 and got.shape == (len(homes),)
    if kernel:
        want = j_ops.hopscotch_lookup(t_lo, t_hi, homes, q_lo, q_hi,
                                      window=window)
    else:
        want = hopscotch_lookup_ref(*(jnp.asarray(x) for x in (
            t_lo, t_hi, homes, q_lo, q_hi)), window)
    return got.numpy(), np.asarray(want)


def _dense(rng, window, n_q, n_tiles=16):
    n_slots = window * n_tiles
    t_lo = rng.integers(0, 6, n_slots, dtype=np.uint32)
    t_hi = rng.integers(0, 2, n_slots, dtype=np.uint32)
    homes = rng.integers(0, n_slots - 2 * window, n_q).astype(np.int32)
    q_lo = rng.integers(0, 6, n_q, dtype=np.uint32)
    q_hi = rng.integers(0, 2, n_q, dtype=np.uint32)
    return t_lo, t_hi, homes, q_lo, q_hi


@pytest.mark.parametrize("n_q", [1, 2, 3, 9, 17, 33, 100])
@pytest.mark.parametrize("window", [8, 32])
def test_lookup_parity_matrix(n_q, window, rng):
    """Ragged batch sizes (pow2 bucketing with pad rows that would match
    EMPTY slots) and dense collisions, so first-match ties are exercised.
    The Pallas kernel runs for the small batches, its oracle for the
    rest."""
    got, want = _both(*_dense(rng, window, n_q), window, kernel=n_q <= 9)
    np.testing.assert_array_equal(got, want)


def test_lookup_empty_table(rng):
    window, n_q = 16, 9
    t = np.zeros(window * 8, np.uint32)
    homes = rng.integers(0, window * 6, n_q).astype(np.int32)
    q = rng.integers(1, 2 ** 32, n_q, dtype=np.uint32)
    got, want = _both(t, t, homes, q, q, window)
    np.testing.assert_array_equal(got, want)
    assert (got == -1).all()


@pytest.mark.parametrize("window", [8, 32, 64, 128])
@pytest.mark.parametrize("n_q", [1, 7, 64])
def test_lookup_full_width_keys(window, n_q, rng):
    """Full 32-bit halves (the int32 bit patterns go negative) with hits
    planted at random offsets."""
    n_slots = window * 16
    t_lo = rng.integers(0, 2 ** 32, n_slots, dtype=np.uint32)
    t_hi = rng.integers(0, 2 ** 32, n_slots, dtype=np.uint32)
    homes = rng.integers(0, n_slots - 2 * window, n_q).astype(np.int32)
    q_lo = rng.integers(0, 2 ** 32, n_q, dtype=np.uint32)
    q_hi = rng.integers(0, 2 ** 32, n_q, dtype=np.uint32)
    for i in range(0, n_q, 2):
        off = int(rng.integers(0, window))
        q_lo[i], q_hi[i] = t_lo[homes[i] + off], t_hi[homes[i] + off]
    got, want = _both(t_lo, t_hi, homes, q_lo, q_hi, window,
                      kernel=window <= 32 and n_q <= 7)
    np.testing.assert_array_equal(got, want)
    assert (got[::2] >= 0).all()


def test_lookup_first_match_wins():
    window, n_slots, home = 16, 128, 5
    t_lo = np.zeros(n_slots, np.uint32)
    t_hi = np.zeros(n_slots, np.uint32)
    t_lo[home + 3] = t_lo[home + 9] = 77
    got, want = _both(t_lo, t_hi, np.asarray([home], np.int32),
                      np.asarray([77], np.uint32),
                      np.asarray([0], np.uint32), window)
    assert got[0] == want[0] == 3


def test_plain_lookup_slots_outside_table_never_match():
    """The CUDA kernel's contract beyond the reference's: a window that
    runs past N (or starts below 0) matches only inside the table."""
    t = torch.zeros(8, dtype=torch.int32)
    homes = torch.tensor([6, -2, 7], dtype=torch.int32)
    zero = torch.zeros(3, dtype=torch.int32)
    got = hopscotch_lookup_plain(t, t, homes, zero, zero, 4)
    assert got.tolist() == [0, 2, 0]
    none = hopscotch_lookup_plain(t[:0], t[:0], homes, zero, zero, 4)
    assert none.tolist() == [-1, -1, -1]


@pytest.mark.parametrize("window", [1, 4, 33, 128, 256])
def test_lookup_edges_match_reference(window):
    """The redesigned kernel's edge cases (``hop_edge_case``, shared with
    the card tests): a first hit at every offset of a window, so in every
    lane group and step; second copies later in windows; windows that start
    below 0 and run past N.  The JAX op reads its table's pad, so the table
    sits between pad slots whose keys no query holds (high half 2^32 - 1),
    and a slot outside the port's table matches on neither side.  The JAX
    Pallas kernel (interpret mode) runs for H <= 33, its oracle beyond."""
    t_lo, t_hi, homes, q_lo, q_hi = hop_edge_case(window, window)
    n = t_lo.shape[0]
    total = -(-(2 * window + n + 2 * window + 8) // window) * window
    p_lo = (0xDEAD0000 + np.arange(total)).astype(np.uint32)
    p_hi = np.full(total, 0xFFFFFFFF, np.uint32)
    p_lo[window:window + n] = t_lo.view(np.uint32)
    p_hi[window:window + n] = t_hi.view(np.uint32)
    want = j_ops.hopscotch_lookup(
        p_lo, p_hi, homes + window, q_lo.view(np.uint32),
        q_hi.view(np.uint32), window=window, use_kernel=window <= 33)
    got = t_ops.hopscotch_lookup_device(
        *(torch.from_numpy(x) for x in (t_lo, t_hi, homes, q_lo, q_hi)),
        window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:window].tolist() == list(range(window))


def test_lookup_rejects_bad_operands():
    t = torch.zeros(16, dtype=torch.int32)
    q = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        t_ops.hopscotch_lookup_device(t.long(), t, q, q, q, window=4)
    with pytest.raises(ValueError, match="window"):
        t_ops.hopscotch_lookup_device(t, t, q, q, q, window=0)


# ---------------------------------------------------------------------------
# The device insert path.
# ---------------------------------------------------------------------------

def _schedule(seed, n, window, n_ins, key_range):
    """Random inserts (duplicate keys included) into a table of n slots,
    replayed through the JAX op and the port's, comparing planes, status,
    probes, swaps and the write log after every insert."""
    rng = np.random.default_rng(seed)
    shape = n + 2 * window
    j_planes = [jnp.zeros(shape, jnp.uint32) for _ in range(4)]
    t_planes = [torch.zeros(shape, dtype=torch.int32) for _ in range(4)]
    statuses = set()
    for _ in range(n_ins):
        key = int(rng.integers(1, key_range))
        val = int(rng.integers(1, 1 << 63))
        lo, hi = key & 0xFFFFFFFF, key >> 32
        vlo, vhi = val & 0xFFFFFFFF, val >> 32
        home = int(np.asarray(j_ops._murmur3_u32(jnp.uint32(lo)))) % n
        *j_planes, st, pr, sw, log, n_log = j_ops.hopscotch_insert_device(
            *j_planes, np.int32(home), np.uint32(lo), np.uint32(hi),
            np.uint32(vlo), np.uint32(vhi), window=window)
        t_st, t_pr, t_sw, t_log = t_ops.hopscotch_insert_device(
            *t_planes, home, lo, hi, vlo, vhi, window=window)
        assert (t_st, t_pr, t_sw) == (int(st), int(pr), int(sw))
        assert t_log == np.asarray(log)[:int(n_log)].tolist()
        for jp, tp in zip(j_planes, t_planes):
            np.testing.assert_array_equal(
                tp.numpy(), np.asarray(jp).view(np.int32))
        statuses.add(t_st)
        if t_st == 2:             # the host would rehash: start afresh
            j_planes = [jnp.zeros(shape, jnp.uint32) for _ in range(4)]
            t_planes = [torch.zeros(shape, dtype=torch.int32)
                        for _ in range(4)]
    return statuses


@pytest.mark.parametrize("seed,n,window,n_ins,key_range", [
    (0, 64, 8, 70, 1 << 40),      # 64-bit keys, fills past the windows
    (1, 32, 4, 40, 60),           # dense duplicates: value updates
    (2, 16, 2, 30, 1 << 20),      # tiny windows: hop chains and failures
    (3, 64, 1, 30, 1 << 20),      # degenerate window: no hop candidates
])
def test_insert_device_matches_reference(seed, n, window, n_ins, key_range):
    statuses = _schedule(seed, n, window, n_ins, key_range)
    assert 1 in statuses


def test_insert_device_covers_every_outcome():
    """Across the schedules above: value update, install, rehash."""
    seen = set()
    for args in [(1, 32, 4, 40, 60), (2, 16, 2, 30, 1 << 20)]:
        seen |= _schedule(*args)
    assert seen == {0, 1, 2}


def test_delete_device_clears_key_and_value():
    planes = [torch.arange(1, 9, dtype=torch.int32) for _ in range(4)]
    t_ops.hopscotch_delete_device(*planes, 3)
    for p in planes:
        assert p[3] == 0 and int(p.sum()) == 36 - 4
