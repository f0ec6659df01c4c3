"""Parity: the port's fused multi-set XAM search (its plain version, which
the wrapper runs for CPU tensors) against the JAX ``xam_search_multiset``
(the Pallas kernel in interpret mode), with exact equality, over
tests/test_kernels.py's multiset matrices — plus the wrapper's own rules.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by tests/test_torch_gpu.py."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import pack_bits_np
from repro.kernels.xam_search import ops as j_ops
from repro.kernels.xam_search.kernel import xam_search_multiset_pallas
from repro_torch.kernels.edge_cases import multiset_edge_case
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.kernels.xam_search.ref import (unpack_rows,
                                                xam_search_multiset_plain)


def _random_multiset(rng, n_sets, r, c, n_q, plant_every=3):
    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    words = rng.integers(0, 2 ** 32, n_q, dtype=np.uint32)
    sets = rng.integers(0, n_sets, n_q).astype(np.int32)
    bits = j_ops.words_to_bits_np(words, r)
    for i in range(0, n_q, plant_every):   # guaranteed valid hits
        w = i % c
        planes[sets[i], :, w] = bits[i]
        valid[sets[i], w] = 1
    return planes, valid, bits, sets


def _both(bits, sets, planes, valid, scoring="int8", packed=False):
    if packed:
        planes = pack_bits_np(planes, axis=1)
    want = np.asarray(j_ops.xam_search_multiset(
        bits, sets, jnp.asarray(planes), jnp.asarray(valid),
        scoring=scoring))
    got = t_ops.xam_search_multiset(
        bits, sets, torch.from_numpy(planes), torch.from_numpy(valid),
        scoring=scoring)
    assert got.dtype == np.int32 and got.shape == want.shape
    return got, want


# The reference's two scorings are bit-identical by its own tests; the
# port validates the flag and runs one exact compare.  Both scorings run
# at 8 sets, the int8 default across the whole (n_q, n_sets) grid.
_GRID = [(q, n, "int8") for q in (1, 7, 64, 130, 300) for n in (1, 8, 32)]
_GRID += [(q, 8, "f32") for q in (1, 7, 64, 130, 300)]


@pytest.mark.parametrize("n_q,n_sets,scoring", _GRID)
def test_multiset_matches_reference(n_q, n_sets, scoring, rng):
    planes, valid, bits, sets = _random_multiset(rng, n_sets, 32, 256, n_q)
    got, want = _both(bits, sets, planes, valid, scoring)
    np.testing.assert_array_equal(got, want)
    assert (got[::3] >= 0).all()           # planted hits found


@pytest.mark.parametrize("n_q,n_sets,r,scoring", [
    (q, n, r, "int8") for q, n in ((1, 1), (13, 8), (100, 6), (300, 32))
    for r in (16, 24, 32)] + [
    (q, n, 32, "f32") for q, n in ((1, 1), (13, 8), (100, 6), (300, 32))])
def test_multiset_packed_matches_reference(n_q, n_sets, r, scoring, rng):
    planes, valid, bits, sets = _random_multiset(rng, n_sets, r, 96, n_q)
    valid[::2] = 0                          # half the sets empty
    if n_sets > 1:
        sets[sets == n_sets - 1] = 0        # one set gets no query
    got_p, want = _both(bits, sets, planes, valid, scoring, packed=True)
    got_i, _ = _both(bits, sets, planes, valid, scoring)
    np.testing.assert_array_equal(got_p, want)
    np.testing.assert_array_equal(got_i, want)


@pytest.mark.parametrize("packed", [False, True])
def test_multiset_all_sets_empty(packed, rng):
    planes = np.zeros((4, 16, 128), np.int8)
    valid = np.zeros((4, 128), np.int8)
    bits = j_ops.words_to_bits_np(
        rng.integers(0, 2 ** 32, 11, dtype=np.uint32), 16)
    sets = rng.integers(0, 4, 11).astype(np.int32)
    got, want = _both(bits, sets, planes, valid, packed=packed)
    assert (got == -1).all() and (want == -1).all()


def test_multiset_first_valid_way_wins_and_validity_fused():
    planes = np.zeros((2, 16, 128), np.int8)
    valid = np.zeros((2, 128), np.int8)
    bits = j_ops.words_to_bits_np(np.asarray([77], np.uint32), 16)
    for w in (9, 40, 70):
        planes[1, :, w] = bits[0]
    valid[1, 40] = valid[1, 70] = 1         # way 9 matches but is invalid
    got, want = _both(bits, np.asarray([1]), planes, valid)
    assert got[0] == want[0] == 40


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("r", [1, 24, 33, 64, 512])
@pytest.mark.parametrize("c", [96, 700])
def test_multiset_edges_match_reference(c, r, packed):
    """The redesigned kernel's edge cases (``multiset_edge_case``, shared
    with the card tests): first matches at columns 0, 3, 4, 127, 128, 511
    and C - 1 among several valid matches, R across the word templates
    (packed8 pads R to a multiple of 8), all-zero mask rows beside hits in
    one set, a dead block and a set with no valid way.  The port's wrapper
    (its plain version) against the JAX Pallas kernel in interpret mode,
    exactly."""
    *arrays, firsts = multiset_edge_case(r + c, r, c, 16, packed)
    want = np.asarray(xam_search_multiset_pallas(
        *(jnp.asarray(x) for x in arrays), block_q=16, interpret=True))
    got = t_ops.xam_search_multiset_device(
        *(torch.from_numpy(x) for x in arrays), block_q=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:16 * len(firsts):16].tolist() == firsts
    assert (got[1:16 * len(firsts):16] == -1).all()


def test_plain_dead_blocks_and_zero_mask_rows(rng):
    """The kernel's launch-layout rules, which ref.py lacks: dead blocks
    and all-zero mask rows report -1 even where a valid column exists."""
    planes = torch.from_numpy(rng.integers(0, 2, (2, 8, 32)).astype(np.int8))
    valid = torch.ones((2, 32), dtype=torch.int8)
    keys = torch.zeros((32, 8), dtype=torch.int8)
    masks = torch.zeros((32, 8), dtype=torch.int8)
    masks[16:20] = 1
    masks[0:4] = 1
    keys[0:4] = planes[0, :, 5]
    keys[16:20] = planes[1, :, 7]
    out = xam_search_multiset_plain(
        keys, masks, planes, valid, torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([1, 0], dtype=torch.int32), block_q=16)
    assert (out[0:4] <= 5).all() and (out[0:4] >= 0).all()
    assert (out[4:16] == -1).all()          # zero-mask rows in a live block
    assert (out[16:] == -1).all()           # the dead block


def test_unpack_rows_lsb_first(rng):
    bits = rng.integers(0, 2, (3, 24, 10)).astype(np.int8)
    packed = torch.from_numpy(pack_bits_np(bits, axis=1))
    np.testing.assert_array_equal(unpack_rows(packed).numpy(), bits)


def _operands(rng, packed=False):
    planes, valid, bits, sets = _random_multiset(rng, 4, 16, 64, 20)
    keys, masks, bs, live, _ = t_ops.pack_multiset_batch(bits, sets, 4, 16)
    if packed:
        planes = pack_bits_np(planes, axis=1)
    return [torch.from_numpy(x) for x in (keys, masks, planes, valid, bs,
                                          live)]


def test_wrapper_runs_plain_version_for_cpu_tensors(rng):
    ops = _operands(rng)
    before = t_ops.LAUNCH_COUNT
    got = t_ops.xam_search_multiset_device(*ops, block_q=16)
    assert t_ops.LAUNCH_COUNT == before + 1
    assert torch.equal(got, xam_search_multiset_plain(*ops, block_q=16))


def test_wrapper_rejects_bad_arguments(rng):
    ops = _operands(rng)
    with pytest.raises(ValueError, match="scoring"):
        t_ops.xam_search_multiset_device(*ops, block_q=16, scoring="bf16")
    bad = list(ops)
    bad[2] = ops[2].to(torch.int16)
    with pytest.raises(TypeError, match="planes"):
        t_ops.xam_search_multiset_device(*bad, block_q=16)
    bad = list(ops)
    bad[0] = ops[0].to(torch.int32)
    with pytest.raises(TypeError, match="keys"):
        t_ops.xam_search_multiset_device(*bad, block_q=16)
    with pytest.raises(ValueError, match="multiple of block_q"):
        t_ops.xam_search_multiset_device(*ops, block_q=24)
    # packed planes carry no row count of their own: 20-bit keys cannot
    # ride a 24-row packed plane
    planes = torch.zeros((2, 3, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 8|packed"):
        t_ops.xam_search_multiset(
            np.zeros((4, 20), np.int8), np.zeros(4, np.int32), planes,
            torch.zeros((2, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="set ids"):
        t_ops.xam_search_multiset(
            np.zeros((1, 24), np.int8), np.asarray([5]), planes,
            torch.zeros((2, 64), dtype=torch.int8))
