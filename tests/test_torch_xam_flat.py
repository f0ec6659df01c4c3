"""Parity: the port's flat XAM search (its plain version, which the wrapper
runs for CPU tensors), ``xam_match_index``, ``dedup_mask`` and the Fig. 6
``MonarchDevice`` against the JAX package, with exact equality, over
tests/test_kernels.py's flat-search shapes (int8 and packed8 planes, both
scorings, planted, widened and all-masked rows) and tests/test_controller.py's
Fig. 6 flows (same results, same ``command_log``).  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py`` and
tests/test_torch_gpu.py."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import MonarchDevice as JDevice
from repro.data import pipeline as j_pipe
from repro.kernels.xam_search import ops as j_ops
from repro.kernels.xam_search.ref import xam_match_index_ref, xam_search_ref
from repro_torch.core.api import MonarchDevice as TDevice
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels.common import pack_bits_np
from repro_torch.kernels.edge_cases import FLAT_RAGGED_SHAPE, flat_edge_case
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.kernels.xam_search.ref import (xam_match_index_plain,
                                                xam_search_plain)

XAM_SHAPES = [
    (1, 8, 8),          # tiny
    (3, 64, 512),       # one Monarch set (odd Q)
    (8, 64, 512),
    (128, 64, 512),     # one full query block of the TPU kernel
    (130, 64, 513),     # both dims ragged
    (16, 32, 100),      # narrow key, ragged columns
    (5, 512, 64),       # tall keys
    (5, 33, 64),        # R not a multiple of 8 (packed8 pads it)
]


def _search(keys, data, masks, **kw):
    return t_ops.xam_search(torch.from_numpy(keys), torch.from_numpy(data),
                            None if masks is None else torch.from_numpy(masks),
                            **kw).numpy()


@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
@pytest.mark.parametrize("q,r,c", XAM_SHAPES)
def test_flat_search_matches_reference(q, r, c, plane_format, rng):
    """Random partial masks.  The JAX side runs its Pallas kernel
    (interpret mode) on the small shapes and its ref oracle on the rest."""
    keys = rng.integers(0, 2, (q, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    masks = rng.integers(0, 2, (q, r)).astype(np.int8)
    masks[::4] = 0                              # all-masked rows
    got = _search(keys, data, masks, plane_format=plane_format)
    if q * c <= 8 * 512:
        want = j_ops.xam_search(keys, data, masks, plane_format=plane_format)
    else:
        want = xam_search_ref(*(jnp.asarray(x) for x in (keys, data, masks)))
    assert got.dtype == np.int8 and got.shape == (q, c)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[::4] == 1).all()                # all-masked match all


@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
def test_ragged_edge_case_matches_reference(plane_format):
    """The flat search's ragged edge case (C not a multiple of 4, R not a
    multiple of 32 or 8, Q over two staged chunks), which the card holds
    every candidate block pair to: the plain version against the
    reference's oracle, planted hits and all-zero mask rows included."""
    keys, masks, data = flat_edge_case(0, *FLAT_RAGGED_SHAPE)
    q, r, c = FLAT_RAGGED_SHAPE
    assert c % 4 and r % 32 and r % 8
    got = _search(keys, data, masks, plane_format=plane_format)
    want = xam_search_ref(*(jnp.asarray(x) for x in (keys, data, masks)))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0, c - 1] == 1 and (got[1::7] == 1).all()
    assert got[3::3].any(axis=1).all()


@pytest.mark.parametrize("scoring", ["int8", "f32"])
@pytest.mark.parametrize("q,r,c", [(3, 64, 512), (64, 32, 128), (1, 8, 8)])
def test_both_scorings_match_reference(q, r, c, scoring, rng):
    keys = rng.integers(0, 2, (q, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    masks = rng.integers(0, 2, (q, r)).astype(np.int8)
    got = _search(keys, data, masks, scoring=scoring)
    want = j_ops.xam_search(keys, data, masks, scoring=scoring)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_planted_and_widened_matches(rng):
    """Planted columns match, a one-bit corruption does not, and masking
    bits out only adds matches — on both packages."""
    r, c = 64, 512
    key = rng.integers(0, 2, (1, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    data[:, 7] = data[:, 200] = data[:, 201] = key[0]
    data[17, 201] ^= 1
    full = _search(key, data, None)
    np.testing.assert_array_equal(full, np.asarray(j_ops.xam_search(key, data)))
    assert full[0, 7] == full[0, 200] == 1 and full[0, 201] == 0
    mask = np.ones((1, r), np.int8)
    mask[0, :20] = 0
    partial = _search(key, data, mask)
    np.testing.assert_array_equal(
        partial, np.asarray(j_ops.xam_search(key, data, mask)))
    assert (partial >= full).all() and partial[0, 201] == 1


def test_knobs_validated():
    k = torch.zeros((1, 8), dtype=torch.int8)
    d = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="scoring"):
        t_ops.xam_search(k, d, scoring="bf16")
    with pytest.raises(ValueError, match="plane_format"):
        t_ops.xam_search(k, d, plane_format="packed4")
    with pytest.raises(ValueError, match="shape"):
        t_ops.xam_search(k, d[:7])


def test_plain_search_of_a_packed_plane(rng):
    """The kernel's packed8 operand: ceil(R/8) rows of words with the
    key's R < 8 * Rp."""
    keys = rng.integers(0, 2, (9, 20)).astype(np.int8)
    data = rng.integers(0, 2, (20, 70)).astype(np.int8)
    masks = rng.integers(0, 2, (9, 20)).astype(np.int8)
    packed = pack_bits_np(np.concatenate([data, np.zeros((4, 70), np.int8)]),
                          axis=0)
    np.testing.assert_array_equal(
        t_ops.pack_rows(torch.from_numpy(data)).numpy(), packed)
    got = xam_search_plain(*(torch.from_numpy(x) for x in (keys, packed,
                                                           masks)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(xam_search_ref(keys, data, masks)))


def test_match_index_matches_reference(rng):
    r, c = 32, 96
    keys = rng.integers(0, 2, (4, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    data[:, 50] = keys[2]
    data[:, 60] = keys[2]
    got = t_ops.xam_match_index(torch.from_numpy(keys),
                                torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_ops.xam_match_index(keys, data)))
    assert got[2] == 50 and got.dtype == np.int32
    masks = rng.integers(0, 2, (4, r)).astype(np.int8)
    np.testing.assert_array_equal(
        xam_match_index_plain(*(torch.from_numpy(x) for x in (
            keys, data, masks))).numpy(),
        np.asarray(xam_match_index_ref(keys, data, masks)))


def test_words_bits_roundtrip(rng):
    words = rng.integers(0, 2 ** 32, 64, dtype=np.uint32)
    bits = t_ops.words_to_bits(torch.from_numpy(words.astype(np.int64)), 32)
    np.testing.assert_array_equal(bits.numpy(),
                                  j_ops.words_to_bits_np(words, 32))
    np.testing.assert_array_equal(t_ops.bits_to_words(bits).numpy(), words)


@pytest.mark.parametrize("shape", [(6, 5), (40,)])
def test_dedup_mask_matches_reference(shape, rng):
    n = int(np.prod(shape))
    fps = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    stored = j_ops.words_to_bits_np(fps.reshape(-1)[::3], 32).T.copy()
    stored = np.concatenate(
        [stored, rng.integers(0, 2, (32, 50)).astype(np.int8)], axis=1)
    before = t_ops.FLAT_LAUNCH_COUNT
    got = t_pipe.dedup_mask(fps, torch.from_numpy(stored))
    assert t_ops.FLAT_LAUNCH_COUNT == before + 1
    want = j_pipe.dedup_mask(fps, jnp.asarray(stored))
    np.testing.assert_array_equal(got, want)
    assert got.shape == shape and got.reshape(-1)[::3].all()
    assert got.sum() < n


# ---------------------------------------------------------------------------
# Fig. 6 user-space API.
# ---------------------------------------------------------------------------

def _pair(**kw):
    return JDevice(**kw), TDevice(**kw, device="cpu")


def _same(ref, port, fn):
    got, want = fn(port), fn(ref)
    assert got == want
    assert port.command_log == ref.command_log
    return got


def test_fig6_kv_store_flow():
    ref, port = _pair(n_sets=2, key_bits=64, set_cols=8)
    for dev in (ref, port):
        keys, data = dev.flat_cam_malloc(12), dev.flat_ram_malloc(12)
        dev.allocs = (keys, data)
        for i, (k, v) in enumerate([(0xAAA, 111), (0xBBB, 222),
                                    (0xCCC, 333), (1 << 63 | 5, 1 << 40),
                                    (0xFFFF_FFFF_FFFF_FFFF, 9)]):
            dev.cam_write(keys, i + 6 * (i % 2), k)
            dev.ram_write(data, i + 6 * (i % 2), v)
    lookup = lambda k, **kw: lambda d: d.kv_lookup(*d.allocs, k, **kw)
    assert _same(ref, port, lookup(0xBBB)) == 222
    assert _same(ref, port, lookup(1 << 63 | 5)) == 1 << 40
    assert _same(ref, port, lookup(0xFFFF_FFFF_FFFF_FFFF)) == 9
    assert _same(ref, port, lookup(0xDDD)) is None


def test_fig6_masked_partial_search():
    ref, port = _pair(n_sets=1, key_bits=64, set_cols=8)
    for dev in (ref, port):
        dev.allocs = (dev.flat_cam_malloc(8), dev.flat_ram_malloc(8))
        dev.cam_write(dev.allocs[0], 0, 0x12_34)
        dev.ram_write(dev.allocs[1], 0, 999)
    assert _same(ref, port, lambda d: d.kv_lookup(*d.allocs, 0x12_99)) is None
    assert _same(ref, port, lambda d: d.kv_lookup(*d.allocs, 0x12_00,
                                                  mask=0xFF00)) == 999


def test_api_search_elision_visible_in_command_log():
    ref, port = _pair(n_sets=1, key_bits=64, set_cols=8)
    for dev in (ref, port):
        keys = dev.flat_cam_malloc(8)
        dev.cam_write(keys, 2, 0x42)
        dev.write_key(0x42)
        dev.keys_alloc = keys
    before = t_ops.FLAT_LAUNCH_COUNT
    assert _same(ref, port, lambda d: d.read_match(d.keys_alloc)) == 2
    assert _same(ref, port, lambda d: d.read_match(d.keys_alloc)) == 2
    assert t_ops.FLAT_LAUNCH_COUNT == before + 1     # the second is fresh
    assert sum(c.startswith("S ") for c in port.command_log) == 1


def test_api_malloc_exhaustion_and_default_device():
    _, port = _pair(n_sets=1, key_bits=64, set_cols=8)
    port.flat_cam_malloc(8)
    with pytest.raises(MemoryError):
        port.flat_cam_malloc(1)
    with pytest.raises(MemoryError):
        port.flat_ram_malloc(9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TDevice()
