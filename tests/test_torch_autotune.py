"""The port's measured query-block width (``repro_torch/kernels/autotune.py``).

Mirrors the multi-set cases of ``tests/test_autotune.py``: the cold
fallback, cold and warm answers bit-identical, a corrupt cache is cold,
the committed cache is well formed, a cached family is served when the
backend matches, the fingerprint tracks the content, one width per
bucket.  Adds the cold width against the reference's cold width for
every batch size up to 2048, and the sweep itself on the CPU.  The width
is a layout knob: it never changes an answer.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as j_autotune
from repro.kernels.xam_search import ops as j_ops
from repro_torch.kernels import autotune
from repro_torch.kernels.common import pack_bits_np
from repro_torch.kernels.xam_search import ops as xam_ops

CPU = torch.device("cpu")


@pytest.fixture
def cold_cache(tmp_path, monkeypatch):
    """Point the loader at a nonexistent cache file for the duration."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "absent.json"))
    autotune.reset_cache()
    yield
    autotune.reset_cache()


def _cache(path, widths: dict, backend: str = "cpu") -> None:
    """A cache file whose ``backend`` families pick ``widths[(fmt,
    bucket)]``."""
    fams = {f"xam_multiset/{backend}/{fmt}/{bucket}": {
        "block_q": bq, "median_us": 1.0, "swept": {str(bq): 1.0}}
        for (fmt, bucket), bq in widths.items()}
    path.write_text(json.dumps({"version": 1, "backend": backend,
                                "block_q_candidates": [8, 16, 32, 64, 128],
                                "families": fams}))


def test_cold_cache_falls_back_to_heuristic(cold_cache):
    assert autotune.multiset_block_q(16, device=CPU) == \
        autotune.MULTISET_BLOCK_Q
    assert autotune.multiset_block_q(autotune.WIDE_BLOCK_AT - 1,
                                     device=CPU) == autotune.MULTISET_BLOCK_Q
    assert autotune.multiset_block_q(autotune.WIDE_BLOCK_AT, device=CPU) == \
        autotune.WIDE_BLOCK_Q
    assert autotune.multiset_block_q(1000, "packed8", CPU) == \
        autotune.WIDE_BLOCK_Q
    assert autotune.cache_fingerprint() == "cold"
    # the serving path's constants are the fallback's
    assert (xam_ops.MULTISET_BLOCK_Q, xam_ops.WIDE_BLOCK_AT,
            xam_ops.WIDE_BLOCK_Q) == (16, 256, 64)


@pytest.mark.parametrize("fmt", ["int8", "packed8"])
def test_cold_width_matches_reference(tmp_path, monkeypatch, fmt):
    """Every batch size 1..2048: the port's cold width (and its committed
    cache's, on the CPU) is the reference's cold width."""
    monkeypatch.setenv(j_autotune.CACHE_ENV, str(tmp_path / "absent.json"))
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    j_autotune.reset_cache()
    autotune.reset_cache()
    try:
        for n in range(1, 2049):
            want = j_autotune.multiset_block_q(n, fmt)
            assert autotune.multiset_block_q(n, fmt, CPU) == want, n
            assert xam_ops._pick_block_q(n, None, fmt, CPU) == want, n
    finally:
        j_autotune.reset_cache()
        autotune.reset_cache()


def test_cold_and_warm_results_bit_identical(tmp_path, monkeypatch, rng):
    """Widths from a warm cache give the SAME answers as the cold ones,
    and as the reference's — the sweep tunes speed, not semantics."""
    n_sets, r, c = 8, 32, 256
    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    cases = []
    for n_q in (50, 300):            # one batch in each bucket
        bits = xam_ops.words_to_bits_np(
            rng.integers(0, 2 ** 32, n_q, dtype=np.uint32), r)
        sets = rng.integers(0, n_sets, n_q).astype(np.int32)
        # plant a hit for every third query
        for i in range(0, n_q, 3):
            w = int(rng.integers(0, c))
            planes[sets[i], :, w] = bits[i]
            valid[sets[i], w] = 1
        cases.append((bits, sets))
    formats = [("int8", planes), ("packed8", pack_bits_np(planes, 1))]

    def answers():
        return {(fmt, len(sets)): xam_ops.xam_search_multiset(
                    bits, sets, torch.from_numpy(pl), torch.from_numpy(valid))
                for fmt, pl in formats for bits, sets in cases}

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "absent.json"))
    autotune.reset_cache()
    cold = answers()
    warm_file = tmp_path / "warm.json"
    _cache(warm_file, {("int8", "narrow"): 8, ("int8", "wide"): 128,
                       ("packed8", "narrow"): 32, ("packed8", "wide"): 8})
    monkeypatch.setenv(autotune.CACHE_ENV, str(warm_file))
    autotune.reset_cache()
    try:
        assert autotune.multiset_block_q(300, "packed8", CPU) == 8
        warm = answers()
    finally:
        autotune.reset_cache()
    for (fmt, n_q), got in warm.items():
        np.testing.assert_array_equal(got, cold[(fmt, n_q)])
        bits, sets = next(c for c in cases if len(c[1]) == n_q)
        pl = dict(formats)[fmt]
        want = np.asarray(j_ops.xam_search_multiset(
            bits, sets, jnp.asarray(pl), jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).sum() > n_q // 4      # the planted hits


def test_corrupt_cache_is_cold(tmp_path, monkeypatch):
    for text in ("{not json", "[1, 2]", '{"families": [1]}'):
        bad = tmp_path / "bad.json"
        bad.write_text(text)
        monkeypatch.setenv(autotune.CACHE_ENV, str(bad))
        autotune.reset_cache()
        try:
            assert autotune.multiset_block_q(16, device=CPU) == \
                autotune.MULTISET_BLOCK_Q
            assert autotune.multiset_block_q(300, device=CPU) == \
                autotune.WIDE_BLOCK_Q
            assert autotune.cache_fingerprint() != "cold"   # file exists...
        finally:
            autotune.reset_cache()


def test_committed_cache_well_formed():
    """The checked-in choices were swept on a card: every family key is
    xam_multiset/cuda:<card name>/plane_format/bucket, both plane formats
    and both buckets are covered, nothing is keyed for the CPU, every
    candidate was timed on every shape the path sends, and a family
    leaves its cold width only for a candidate whose upper quartile lies
    under the cold width's lower quartile on every shape."""
    payload = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())
    fams = payload["families"]
    assert fams, "committed cache must not be empty"
    backend = payload["backend"]
    assert backend.startswith("cuda:") and len(backend) > len("cuda:")
    assert payload["timing"].startswith("device")
    assert payload["block_q_candidates"] == list(autotune.BLOCK_Q_CANDIDATES)
    for key, fam in fams.items():
        kernel, b, fmt, bucket = key.split("/")
        assert kernel == "xam_multiset" and b == backend
        assert fmt in ("int8", "packed8")
        assert bucket in ("narrow", "wide")
        assert fam["shapes"] == [list(s) for s in
                                 autotune.BUCKET_SHAPES[bucket]]
        cold = autotune.cold_block_q(fam["shapes"][0][1])
        assert fam["cold_block_q"] == cold
        assert fam["block_q"] in autotune.BLOCK_Q_CANDIDATES
        swept = fam["swept"]
        assert set(swept) == {str(c) for c in autotune.BLOCK_Q_CANDIDATES}
        for t in swept.values():
            assert len(t["median_us"]) == len(fam["shapes"])
            for lo, med, hi in zip(t["q1_us"], t["median_us"],
                                   t["q3_us"]):
                assert 0 < lo <= med <= hi
        if fam["block_q"] != cold:
            won, base = swept[str(fam["block_q"])], swept[str(cold)]
            assert all(hi < lo for hi, lo in zip(won["q3_us"],
                                                  base["q1_us"]))
    assert set(fams) == {f"xam_multiset/{backend}/{fmt}/{bucket}"
                         for fmt in ("int8", "packed8")
                         for bucket in ("narrow", "wide")}


def test_committed_cache_served_when_backend_matches(monkeypatch):
    """On the card the cache was swept on, the lookup answers with the
    committed winners, not the fallback: the backend string is patched to
    the committed one, since this host has no such card."""
    payload = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setattr(autotune, "_backend", lambda dev: payload["backend"])
    autotune.reset_cache()
    try:
        fams = payload["families"]
        for fmt in ("int8", "packed8"):
            for n, bucket in ((16, "narrow"), (1000, "wide")):
                key = autotune.family_key("xam_multiset", fmt, bucket, CPU)
                assert autotune.multiset_block_q(n, fmt, CPU) == \
                    fams[key]["block_q"]
    finally:
        autotune.reset_cache()


def test_fingerprint_tracks_file_content(tmp_path, monkeypatch):
    a = tmp_path / "a.json"
    a.write_text('{"families": {}}')
    monkeypatch.setenv(autotune.CACHE_ENV, str(a))
    autotune.reset_cache()
    try:
        fp1 = autotune.cache_fingerprint()
        a.write_text('{"families": {"x": 1}}')
        fp2 = autotune.cache_fingerprint()
        assert fp1 != fp2 and "cold" not in (fp1, fp2)
        assert len(fp1) == 16
    finally:
        autotune.reset_cache()


@pytest.mark.parametrize("warm", [False, True])
def test_one_width_per_bucket(tmp_path, monkeypatch, warm):
    """Within one bucket every batch size maps to ONE block_q, cold or
    warm."""
    path = tmp_path / "cache.json"
    if warm:
        _cache(path, {("int8", "narrow"): 32, ("int8", "wide"): 8})
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.reset_cache()
    try:
        narrow = {autotune.multiset_block_q(q, device=CPU)
                  for q in (1, 8, 64, 255)}
        wide = {autotune.multiset_block_q(q, device=CPU)
                for q in (256, 300, 1000)}
        assert len(narrow) == 1 and len(wide) == 1
        assert (narrow.pop(), wide.pop()) == ((32, 8) if warm else (16, 64))
    finally:
        autotune.reset_cache()


def test_sweep_on_the_cpu_writes_servable_winners(tmp_path, monkeypatch,
                                                   capsys):
    """``autotune`` on explicitly named host tensors: one family per
    (format, bucket) keyed ``cpu``, timed by host wall clock, choices from
    the candidates, served back once the loader points at the file.  The entry point defaults to
    the card and raises without one.  The path's shapes are cut to one
    small batch per bucket: the plain version at 4096 queries over 128
    sets takes a second a call on the host."""
    monkeypatch.setattr(autotune, "BUCKET_SHAPES", {
        "narrow": ((8, 12),), "wide": ((8, 256),)})
    out = tmp_path / "swept.json"
    assert autotune.main(["--quick", "--device", "cpu", "--out",
                          str(out)]) == 0
    assert "fingerprint" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    assert payload["backend"] == "cpu" and len(payload["families"]) == 4
    assert payload["timing"] == "host wall"
    monkeypatch.setenv(autotune.CACHE_ENV, str(out))
    autotune.reset_cache()
    try:
        for key, fam in payload["families"].items():
            _, _, fmt, bucket = key.split("/")
            assert fam["block_q"] in autotune.BLOCK_Q_CANDIDATES
            for _, n in autotune.BUCKET_SHAPES[bucket]:
                assert autotune.multiset_block_q(n, fmt, CPU) == \
                    fam["block_q"]
    finally:
        autotune.reset_cache()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.main(["--out", str(tmp_path / "never.json")])
    assert not (tmp_path / "never.json").exists()


@pytest.mark.parametrize("case", [
    # (per-rep us on two shapes for the cold width 16 and the candidates
    # 8 and 32, want): a near tie keeps the cold width
    ({16: [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      8: [[4.9, 5.0, 5.1, 5.2, 5.3], [8.9, 9.0, 9.1, 9.2, 9.3]],
      32: [[6.0, 6.1, 6.2, 6.3, 6.4], [9.5, 9.6, 9.7, 9.8, 9.9]]}, 16),
    # clearly faster on one shape, slower on the other: cold
    ({16: [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      8: [[4.0, 4.1, 4.2, 4.3, 4.4], [9.5, 9.6, 9.7, 9.8, 9.9]],
      32: [[6.0, 6.1, 6.2, 6.3, 6.4], [9.5, 9.6, 9.7, 9.8, 9.9]]}, 16),
    # clearly faster on both shapes, one slow rep included: the candidate
    ({16: [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      8: [[4.0, 4.1, 4.2, 4.3, 6.5], [8.0, 8.1, 8.2, 8.3, 8.4]],
      32: [[6.0, 6.1, 6.2, 6.3, 6.4], [9.5, 9.6, 9.7, 9.8, 9.9]]}, 8),
    # two candidates clearly faster: the least sum of medians
    ({16: [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      8: [[4.0, 4.1, 4.2, 4.3, 4.4], [8.0, 8.1, 8.2, 8.3, 8.4]],
      32: [[3.0, 3.1, 3.2, 3.3, 3.4], [8.5, 8.6, 8.7, 8.8, 8.9]]}, 32),
])
def test_choose_leaves_the_cold_width_only_for_a_clear_winner(case):
    times, want = case
    assert autotune._choose(times, 16) == want
