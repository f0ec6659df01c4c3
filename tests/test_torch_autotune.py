"""The port's measured block shapes (``repro_torch/kernels/autotune.py``).

Mirrors the cases of ``tests/test_autotune.py``, for the multi-set
search's ``block_q`` and the flat search's ``(block_q, block_c)``
(``search_blocks``): the cold fallback, cold and warm answers
bit-identical, a corrupt cache is cold, the committed cache is well
formed, a cached family is served when the backend matches, the
fingerprint tracks the content, one shape per bucket.  Adds the cold
width against the reference's cold width for every batch size up to
2048, the flat search's cold pair at the path's shapes, and the sweep
itself on the CPU.  A shape is a layout knob: it never changes an answer.
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
from repro_torch.kernels.xam_search import kernel as kernel_mod
from repro_torch.kernels.xam_search import ops as xam_ops

CPU = torch.device("cpu")
#: A card's device; the lookups below patch ``_backend``, so no card is
#: touched.
CUDA = torch.device("cuda")
#: The flat search's three path shapes (Q, C) and the pair the launcher
#: took there before it was given one.
PATH_GEOMETRY = {(1, 512): (1, 128), (64, 512): (64, 128),
                 (4096, 65536): (128, 1024)}


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


def _search_cache(path, pairs: dict, backend: str = "cpu") -> None:
    """A cache file whose ``backend`` flat families pick ``pairs[(fmt,
    bucket)]`` (a (block_q, block_c) pair, or None for an explicit cold
    entry)."""
    fams = {f"xam_search/{backend}/{fmt}/{bucket}": {
        "block_q": None if pair is None else pair[0],
        "block_c": None if pair is None else pair[1]}
        for (fmt, bucket), pair in pairs.items()}
    path.write_text(json.dumps({"version": 1, "backend": backend,
                                "families": fams}))


@pytest.mark.parametrize("shape", sorted(PATH_GEOMETRY))
def test_flat_geometry_pins_the_path_shapes(shape):
    """The cold pair is the launcher's old heuristic at the Fig. 6 search,
    the reference's sweep shape and the dedup batch; the first two narrow
    their blocks (bucket ``small``), the dedup batch does not."""
    q, c = shape
    assert kernel_mod.flat_geometry(q, c) == PATH_GEOMETRY[shape]
    assert autotune.search_bucket(q, c) == ("large" if c == 65536
                                            else "small")


def test_flat_geometry_is_always_a_legal_pair():
    """Every (Q, C) gets a pair the launcher takes: block_c one of its
    four, block_q at least 1, at most 65535 query blocks, and blocks the
    width of the bucket."""
    for q in (0, 1, 2, 63, 64, 65, 130, 1000, 4096, 8191, 10 ** 6):
        for c in (0, 1, 3, 127, 128, 512, 1001, 4096, 65536, 1 << 22):
            bq, bc = kernel_mod.flat_geometry(q, c)
            assert bc in kernel_mod.FLAT_BLOCK_C and bq >= 1
            assert -(-q // bq) <= 65535
            assert (bc == 1024) == (autotune.search_bucket(q, c) == "large")


def test_served_pairs_are_always_legal(monkeypatch):
    """The pairs ``search_blocks`` serves from the committed cache on its
    card are legal at any query count: a cached ``block_q`` widens where
    ``q`` would pass the grid's 65535 query blocks (the dedup of five
    million fingerprints against 128 columns), and stays the cached
    width below that."""
    payload = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setattr(autotune, "_backend", lambda dev: payload["backend"])
    autotune.reset_cache()
    try:
        for fmt in ("int8", "packed8"):
            for q in (1, 64, 4096, 4_194_240, 4_194_241, 5 * 10 ** 6,
                      10 ** 7):
                for c in (1, 128, 512, 65536):
                    bq, bc = autotune.search_blocks(q, c, fmt, CUDA)
                    assert bc in kernel_mod.FLAT_BLOCK_C and bq >= 1
                    assert -(-q // bq) <= kernel_mod.FLAT_MAX_GRID_Y
                    fam = payload["families"][autotune.family_key(
                        "xam_search", fmt, autotune.search_bucket(q, c),
                        CPU)]
                    if fam["block_q"] is None:
                        assert (bq, bc) == kernel_mod.flat_geometry(q, c)
                    elif q <= fam["block_q"] * kernel_mod.FLAT_MAX_GRID_Y:
                        assert (bq, bc) == (fam["block_q"], fam["block_c"])
    finally:
        autotune.reset_cache()


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


def test_cold_search_cache_gives_flat_geometry(cold_cache, monkeypatch):
    """No cache file: every flat search, on a card or on the CPU, gets
    ``flat_geometry``; so does a CPU run against the committed file."""
    monkeypatch.setattr(autotune, "_backend",
                        lambda dev: "cuda:NVIDIA H100 80GB HBM3")
    for (q, c), pair in PATH_GEOMETRY.items():
        for fmt in ("int8", "packed8"):
            assert autotune.search_blocks(q, c, fmt, CUDA) == pair
            assert autotune.search_blocks(q, c, fmt, CPU) == pair
    assert autotune.search_blocks(1, 512, device=None) == (1, 128)


def test_corrupt_cache_is_cold(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_backend", lambda dev: "cpu")
    for text in ("{not json", "[1, 2]", '{"families": [1]}',
                 '{"families": {"xam_search/cpu/int8/small": 5}}'):
        bad = tmp_path / "bad.json"
        bad.write_text(text)
        monkeypatch.setenv(autotune.CACHE_ENV, str(bad))
        autotune.reset_cache()
        try:
            assert autotune.multiset_block_q(16, device=CPU) == \
                autotune.MULTISET_BLOCK_Q
            assert autotune.multiset_block_q(300, device=CPU) == \
                autotune.WIDE_BLOCK_Q
            for (q, c), pair in PATH_GEOMETRY.items():
                assert autotune.search_blocks(q, c, "int8", CUDA) == pair
            assert autotune.cache_fingerprint() != "cold"   # file exists...
        finally:
            autotune.reset_cache()


def _quartile_winner(swept: dict, won: str, cold: str) -> bool:
    """``won``'s upper quartile under ``cold``'s lower one, less
    ``MIN_GAIN``, on every shape."""
    return all(hi < (1 - autotune.MIN_GAIN) * lo for hi, lo in zip(
        swept[won]["q3_us"], swept[cold]["q1_us"]))


def _check_timed(swept: dict, n_shapes: int) -> None:
    for t in swept.values():
        assert len(t["median_us"]) == n_shapes
        for lo, med, hi in zip(t["q1_us"], t["median_us"], t["q3_us"]):
            assert 0 < lo <= med <= hi


def test_committed_cache_well_formed():
    """The checked-in choices were swept on a card: every family key is
    kernel/cuda:<card name>/plane_format/bucket, both kernels, both plane
    formats and each kernel's two buckets are covered, nothing is keyed
    for the CPU, every candidate (and the flat search's cold pair) was
    timed on every shape of its bucket, and a family leaves its cold
    shape only for a candidate whose upper quartile lies under the cold
    shape's lower quartile, less ``MIN_GAIN``, on every shape; a flat
    family's explicit cold entry has no such candidate."""
    payload = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())
    fams = payload["families"]
    assert fams, "committed cache must not be empty"
    backend = payload["backend"]
    assert backend.startswith("cuda:") and len(backend) > len("cuda:")
    assert payload["timing"].startswith("device")
    assert payload["block_q_candidates"] == list(autotune.BLOCK_Q_CANDIDATES)
    assert payload["block_c_candidates"] == list(autotune.BLOCK_C_CANDIDATES)
    for key, fam in fams.items():
        kernel, b, fmt, bucket = key.split("/")
        assert b == backend and fmt in ("int8", "packed8")
        if kernel == "xam_search":
            assert fam["shapes"] == [list(s) for s in
                                     autotune.SEARCH_SHAPES[bucket]]
            assert fam["cold"] == [list(kernel_mod.flat_geometry(q, c))
                                   for q, _, c in fam["shapes"]]
            assert {autotune.search_bucket(q, c)
                    for q, _, c in fam["shapes"]} == {bucket}
            pairs = {f"{bq}x{bc}" for bq in autotune.BLOCK_Q_CANDIDATES
                     for bc in autotune.BLOCK_C_CANDIDATES}
            assert set(fam["swept"]) == pairs | {"cold"}
            _check_timed(fam["swept"], len(fam["shapes"]))
            if fam["block_q"] is None:
                assert fam["block_c"] is None
                assert not any(_quartile_winner(fam["swept"], p, "cold")
                               for p in pairs)
            else:
                won = f"{fam['block_q']}x{fam['block_c']}"
                assert won in pairs
                assert _quartile_winner(fam["swept"], won, "cold")
            continue
        assert kernel == "xam_multiset"
        assert bucket in ("narrow", "wide")
        assert fam["shapes"] == [list(s) for s in
                                 autotune.BUCKET_SHAPES[bucket]]
        cold = autotune.cold_block_q(fam["shapes"][0][1])
        assert fam["cold_block_q"] == cold
        assert fam["block_q"] in autotune.BLOCK_Q_CANDIDATES
        swept = fam["swept"]
        assert set(swept) == {str(c) for c in autotune.BLOCK_Q_CANDIDATES}
        _check_timed(swept, len(fam["shapes"]))
        if fam["block_q"] != cold:
            assert _quartile_winner(swept, str(fam["block_q"]), str(cold))
    assert set(fams) == {f"{kernel}/{backend}/{fmt}/{bucket}"
                         for fmt in ("int8", "packed8")
                         for kernel, buckets in (
                             ("xam_multiset", ("narrow", "wide")),
                             ("xam_search", ("small", "large")))
                         for bucket in buckets}


def test_committed_cache_served_when_backend_matches(monkeypatch):
    """On the card the cache was swept on, the lookup answers with the
    committed winners, not the fallback: the backend string is patched to
    the committed one, since this host has no such card.  The flat
    search's pair is served for a card only (the plain version takes no
    pair), and a null entry is the cold pair."""
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
            for bucket, shapes in autotune.SEARCH_SHAPES.items():
                fam = fams[autotune.family_key("xam_search", fmt, bucket,
                                               CPU)]
                for q, _, c in shapes:
                    want = (kernel_mod.flat_geometry(q, c)
                            if fam["block_q"] is None
                            else (fam["block_q"], fam["block_c"]))
                    assert autotune.search_blocks(q, c, fmt, CUDA) == want
                    assert autotune.search_blocks(q, c, fmt, CPU) == \
                        kernel_mod.flat_geometry(q, c)
    finally:
        autotune.reset_cache()


def test_search_blocks_served_only_for_the_swept_backend(tmp_path,
                                                         monkeypatch):
    """A pair cached for one card steers that card only: another card
    name, or the CPU, gets the cold pair."""
    path = tmp_path / "warm.json"
    _search_cache(path, {("int8", "small"): (8, 256)}, backend="cuda:A")
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.reset_cache()
    try:
        monkeypatch.setattr(autotune, "_backend", lambda dev: "cuda:A")
        assert autotune.search_blocks(1, 512, "int8", CUDA) == (8, 256)
        assert autotune.search_blocks(1, 512, "packed8", CUDA) == (1, 128)
        assert autotune.search_blocks(1, 512, "int8", CPU) == (1, 128)
        monkeypatch.setattr(autotune, "_backend", lambda dev: "cuda:B")
        assert autotune.search_blocks(1, 512, "int8", CUDA) == (1, 128)
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


def test_fingerprint_and_pair_track_the_file(tmp_path, monkeypatch):
    """Rewriting the cache's flat family changes the fingerprint, and the
    next consult after ``reset_cache`` serves the new pair."""
    path = tmp_path / "cache.json"
    _search_cache(path, {("int8", "large"): (32, 512)})
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.setattr(autotune, "_backend", lambda dev: "cpu")
    autotune.reset_cache()
    try:
        fp1 = autotune.cache_fingerprint()
        assert autotune.search_blocks(4096, 65536, "int8", CUDA) == (32, 512)
        _search_cache(path, {("int8", "large"): (128, 256)})
        fp2 = autotune.cache_fingerprint()
        assert fp1 != fp2 and "cold" not in (fp1, fp2)
        autotune.reset_cache()
        assert autotune.search_blocks(4096, 65536, "int8", CUDA) == \
            (128, 256)
        _search_cache(path, {("int8", "large"): None})
        autotune.reset_cache()
        assert autotune.search_blocks(4096, 65536, "int8", CUDA) == \
            (128, 1024)
    finally:
        autotune.reset_cache()


@pytest.mark.parametrize("warm", [False, True])
def test_one_pair_per_search_bucket(tmp_path, monkeypatch, warm):
    """Within a flat bucket every search maps to ONE pair when warm; cold,
    each gets its own ``flat_geometry``."""
    path = tmp_path / "cache.json"
    if warm:
        _search_cache(path, {("int8", "small"): (16, 512),
                             ("int8", "large"): (64, 1024)})
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.setattr(autotune, "_backend", lambda dev: "cpu")
    autotune.reset_cache()
    try:
        small = [(1, 512), (64, 512), (1, 64), (200, 4096)]
        large = [(4096, 65536), (64, 1 << 18), (8448, 1024)]
        for shapes, bucket in ((small, "small"), (large, "large")):
            assert {autotune.search_bucket(q, c)
                    for q, c in shapes} == {bucket}
            got = {autotune.search_blocks(q, c, "int8", CUDA)
                   for q, c in shapes}
            if warm:
                assert got == {(16, 512) if bucket == "small"
                               else (64, 1024)}
            else:
                assert got == {kernel_mod.flat_geometry(q, c)
                               for q, c in shapes}
    finally:
        autotune.reset_cache()


def test_plain_flat_search_ignores_the_pair(rng):
    """On the CPU the wrapper runs the plain version whatever pair it is
    given, even one the launcher would refuse, and matches the
    reference."""
    keys = rng.integers(0, 2, (9, 40)).astype(np.int8)
    data = rng.integers(0, 2, (40, 77)).astype(np.int8)
    data[:, 5] = keys[2]
    masks = np.ones_like(keys)
    k, d, m = (torch.from_numpy(x) for x in (keys, data, masks))
    want = np.asarray(j_ops.xam_search(keys, data, masks, use_kernel=False))
    for blocks in (None, (1, 128), (128, 1024), (0, 100)):
        got = xam_ops.xam_search_device(k, d, m, blocks=blocks)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[2, 5] == 1


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
    sets takes a second a call on the host; the flat search's to a few
    queries, the large bucket's one query over 132 column blocks."""
    monkeypatch.setattr(autotune, "BUCKET_SHAPES", {
        "narrow": ((8, 12),), "wide": ((8, 256),)})
    monkeypatch.setattr(autotune, "SEARCH_SHAPES", {
        "small": ((1, 8, 64), (4, 8, 64)), "large": ((1, 8, 132 * 1024),)})
    out = tmp_path / "swept.json"
    assert autotune.main(["--quick", "--device", "cpu", "--out",
                          str(out)]) == 0
    assert "fingerprint" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    assert payload["backend"] == "cpu" and len(payload["families"]) == 8
    assert payload["timing"] == "host wall"
    monkeypatch.setenv(autotune.CACHE_ENV, str(out))
    autotune.reset_cache()
    try:
        for key, fam in payload["families"].items():
            kernel, _, fmt, bucket = key.split("/")
            if kernel == "xam_search":
                assert len(fam["swept"]) == 1 + len(
                    autotune.BLOCK_Q_CANDIDATES) * len(
                        autotune.BLOCK_C_CANDIDATES)
                # the plain version takes no pair: served for a card of
                # the swept backend only
                with monkeypatch.context() as mp:
                    mp.setattr(autotune, "_backend", lambda dev: "cpu")
                    for q, _, c in autotune.SEARCH_SHAPES[bucket]:
                        want = (kernel_mod.flat_geometry(q, c)
                                if fam["block_q"] is None
                                else (fam["block_q"], fam["block_c"]))
                        assert autotune.search_blocks(q, c, fmt,
                                                      CUDA) == want
                continue
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
    # faster beyond the reps' spread but by under MIN_GAIN: cold
    ({16: [[100.0, 100.1, 100.2, 100.3, 100.4]],
      8: [[99.0, 99.1, 99.2, 99.3, 99.4]]}, 16),
])
def test_choose_leaves_the_cold_width_only_for_a_clear_winner(case):
    times, want = case
    assert autotune._choose(times, 16) == want


@pytest.mark.parametrize("case", [
    # (per-rep us on two shapes for the cold pairs and two candidate
    # pairs, want): a near tie keeps the cold pair
    ({"cold": [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      "8x256": [[4.9, 5.0, 5.1, 5.2, 5.3], [8.9, 9.0, 9.1, 9.2, 9.3]],
      "64x1024": [[6.0, 6.1, 6.2, 6.3, 6.4], [9.5, 9.6, 9.7, 9.8, 9.9]]},
     "cold"),
    # faster on the Fig. 6 shape only: cold
    ({"cold": [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      "8x256": [[4.0, 4.1, 4.2, 4.3, 4.4], [9.5, 9.6, 9.7, 9.8, 9.9]],
      "64x1024": [[6.0, 6.1, 6.2, 6.3, 6.4], [9.5, 9.6, 9.7, 9.8, 9.9]]},
     "cold"),
    # one pair clearly faster on both shapes, one slow rep included
    ({"cold": [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      "8x256": [[4.0, 4.1, 4.2, 4.3, 6.5], [8.0, 8.1, 8.2, 8.3, 8.4]],
      "64x1024": [[6.0, 6.1, 6.2, 6.3, 6.4], [9.5, 9.6, 9.7, 9.8, 9.9]]},
     "8x256"),
    # two pairs clearly faster: the least sum of medians
    ({"cold": [[5.0, 5.1, 5.2, 5.3, 5.4], [9.0, 9.1, 9.2, 9.3, 9.4]],
      "8x256": [[4.0, 4.1, 4.2, 4.3, 4.4], [8.0, 8.1, 8.2, 8.3, 8.4]],
      "64x1024": [[3.0, 3.1, 3.2, 3.3, 3.4], [8.5, 8.6, 8.7, 8.8, 8.9]]},
     "64x1024"),
    # faster beyond the reps' spread but by under MIN_GAIN (the dedup
    # shape's 0.14% of one sweep): cold
    ({"cold": [[117.0, 117.02, 117.07, 117.19, 117.3]],
      "64x1024": [[116.3, 116.37, 116.5, 116.85, 116.9]]}, "cold"),
])
def test_choose_keeps_the_cold_pair_except_for_a_clear_winner(case):
    """``_choose`` on the flat search's pairs, the cold key standing for
    ``flat_geometry`` at each shape."""
    times, want = case
    assert autotune._choose(times, "cold") == want
