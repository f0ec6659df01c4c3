"""Parity: the port's string match (its plain version, which the wrapper
runs for CPU tensors) and ``apps/stringmatch.py`` against the JAX
``kernels/string_match`` ops and ``apps/stringmatch``, with exact equality:
ragged corpora, matches across the 4096-byte tile boundary, short, long
and oversized patterns.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and tests/test_torch_gpu.py."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.apps import stringmatch as j_app
from repro.kernels.string_match import ops as j_ops
from repro.kernels.string_match.ref import string_match_ref
from repro_torch.apps import stringmatch as t_app
from repro_torch.kernels.string_match import ops as t_ops


_jit_ref = jax.jit(string_match_ref)     # traces its P-step loop once


def _both(text: np.ndarray, pat: np.ndarray, *, kernel=True):
    """The port's wrapper (CPU) and the JAX op: the Pallas kernel in
    interpret mode, or its ref oracle (jitted) for the longer patterns."""
    got = t_ops.string_match(torch.from_numpy(text), torch.from_numpy(pat))
    assert got.dtype == torch.int8 and got.shape == text.shape
    want = (j_ops.string_match(text, pat) if kernel
            else _jit_ref(text, pat))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n,p", [(5000, 1), (5000, 3), (9000, 12),
                                 (4096 * 3 + 17, 100), (37, 12), (12, 12),
                                 (50, 0)])
def test_random_corpus_matches_reference(n, p, rng):
    """N not a multiple of the tile; a 4-letter alphabet so short patterns
    match often.  The Pallas kernel (interpret mode) runs for P <= 12."""
    text = rng.integers(97, 101, n).astype(np.uint8)
    pat = text[n // 3:n // 3 + p].copy() if p <= n - n // 3 else text[:p]
    got, want = _both(text, pat, kernel=p <= 12)
    np.testing.assert_array_equal(got, want)
    assert got.sum() >= 1


@pytest.mark.parametrize("p", [1, 3, 12, 100])
def test_match_across_tile_boundary(p, rng):
    """A match that starts in one 4096-byte tile and ends in the next (the
    halo), one ending on the last byte, and none past N - P."""
    n = 4096 * 2 + 300
    text = rng.integers(97, 123, n).astype(np.uint8)
    pat = rng.integers(65, 91, p).astype(np.uint8)     # not in the text
    for start in (4096 - p // 2 - 1, n - p, 8192 - 1):
        text[start:start + p] = pat[:min(p, n - start)]
    got, want = _both(text, pat, kernel=p <= 12)
    np.testing.assert_array_equal(got, want)
    assert got[n - p] == 1 and got[4096 - p // 2 - 1] == 1
    assert not got[n - p + 1:].any()


def test_pattern_longer_than_text():
    text = np.frombuffer(b"abcab", np.uint8).copy()
    got, want = _both(text, np.frombuffer(b"abcabc", np.uint8).copy())
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_longest_pattern():
    """P at the 4096-byte search coverage, against a numpy sliding-window
    oracle (the reference's P-step loop is too slow to trace at P=4096)."""
    rng = np.random.default_rng(1)
    text = rng.integers(97, 99, 3 * 4096).astype(np.uint8)
    pat = text[1000:1000 + 4096].copy()
    got = t_ops.string_match(torch.from_numpy(text), torch.from_numpy(pat))
    win = np.lib.stride_tricks.sliding_window_view(text, 4096)
    want = np.zeros(text.shape, np.int8)
    want[:win.shape[0]] = (win == pat).all(axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1000] == 1


def test_wrapper_rejects_bad_operands():
    t = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        t_ops.string_match(t.to(torch.int8), t)
    with pytest.raises(ValueError, match="4096"):
        t_ops.string_match(t, torch.zeros(4097, dtype=torch.uint8))


@pytest.mark.parametrize("n,seed", [(4096 * 5 + 123, 0), (777, 4)])
def test_make_corpus_bytes_equal_reference(n, seed):
    np.testing.assert_array_equal(t_app.make_corpus(n, seed),
                                  j_app.make_corpus(n, seed))


@pytest.mark.parametrize("pattern", [b"ab", b"abcab", b"p", b"zz"])
def test_find_report_equals_reference(pattern):
    text = j_app.make_corpus(4096 * 3 + 50, seed=2, alphabet=3)
    before = t_ops.LAUNCH_COUNT
    got = t_app.find(text, pattern, device="cpu")
    assert t_ops.LAUNCH_COUNT == before + 1          # one launch per find
    want = j_app.find(text, pattern)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    # a text already on a device stays there
    on_dev = t_app.find(torch.from_numpy(text), pattern, device="meta")
    assert dataclasses.astuple(on_dev) == dataclasses.astuple(want)


def test_find_defaults_to_the_card():
    text = np.frombuffer(b"abab", np.uint8).copy()
    if torch.cuda.is_available():
        assert t_app.find(text, b"ab").n_matches == 2
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_app.find(text, b"ab")


@pytest.mark.parametrize("case", ["random", "no_match", "overlapping"])
def test_count_matches_equals_reference(case):
    """The port's count (int8 flags counted without an int64 copy) equals
    the JAX ``count_matches`` on seeded corpora: a random 3-letter corpus,
    a pattern that never occurs, and "aaaa" in a run of "a" (overlapping
    matches at every position that fits).  The count is a 0-d int64."""
    rng = np.random.default_rng({"random": 0, "no_match": 1,
                                 "overlapping": 2}[case])
    text = rng.integers(97, 100, 4096 * 2 + 91).astype(np.uint8)
    pat = np.frombuffer(b"abca", np.uint8).copy()
    if case == "no_match":
        pat = np.frombuffer(b"abcz", np.uint8).copy()
    elif case == "overlapping":
        text[100:700] = 97
        pat = np.frombuffer(b"aaaa", np.uint8).copy()
    got = t_ops.count_matches(torch.from_numpy(text), torch.from_numpy(pat))
    want = int(j_ops.count_matches(text, pat))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    assert (want == 0) == (case == "no_match")
    if case == "overlapping":
        assert want >= 600 - 3


@pytest.mark.parametrize("n", [0, 1, 2039, 2040, 2041, 2040 * 3 + 17])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_count_flags_exact(n, density):
    """The byte-lane count at the edges of its 2040-flag body and its
    tail, with every lane full (density 1: 255 ones per lane) and empty."""
    flags = (np.random.default_rng(n).random(n) < density).astype(np.int8)
    got = t_ops.count_flags(torch.from_numpy(flags))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(flags.astype(np.int64).sum())
