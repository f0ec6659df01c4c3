"""Card-only tests of the port (marker ``gpu``): they skip without a CUDA
device and import neither JAX nor the reference package, so they run on
the card's machine as they are:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import pack_bits_np
from repro_torch.kernels.edge_cases import hop_edge_case, multiset_edge_case
from repro_torch.kernels.xam_search import ops
from repro_torch.kernels.xam_search.ref import xam_search_multiset_plain


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _operands(rng, n_sets, r, c, n_q, packed):
    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    sets = rng.integers(0, n_sets, n_q)
    bits = rng.integers(0, 2, (n_q, r)).astype(np.int8)
    planes[sets[::3], :, 11] = bits[::3]
    valid[sets[::3], 11] = 1
    block_q = ops._pick_block_q(n_q, None)
    keys, masks, bs, live, _ = ops.pack_multiset_batch(bits, sets, n_sets,
                                                       block_q)
    if packed:
        planes = pack_bits_np(planes, axis=1)
    return [torch.from_numpy(x).cuda() for x in (keys, masks, planes, valid,
                                                 bs, live)], block_q


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_sets,r,c,n_q", [(8, 32, 512, 96), (6, 24, 96, 100),
                                            (32, 32, 512, 300)])
def test_cuda_kernel_matches_plain_on_card(n_sets, r, c, n_q, packed):
    _needs_card()
    operands, bq = _operands(np.random.default_rng(0), n_sets, r, c, n_q,
                             packed)
    before = ops.LAUNCH_COUNT
    got = ops.xam_search_multiset_device(*operands, block_q=bq)
    torch.cuda.synchronize()
    assert got.is_cuda and ops.LAUNCH_COUNT == before + 1
    assert torch.equal(got, xam_search_multiset_plain(*operands, block_q=bq))
    assert bool((got >= 0).any())


@pytest.mark.gpu
def test_card_lookup_equals_cpu_lookup():
    _needs_card()
    rng = np.random.default_rng(1)
    from repro_torch.serve.kv_index import KVIndexConfig, MonarchKVIndex
    toks = rng.integers(1, 500, (3, 64)).astype(np.int32)
    cfg = dict(n_sets=8, set_ways=16, admit_after_reads=0)
    gpu = MonarchKVIndex(KVIndexConfig(**cfg))
    cpu = MonarchKVIndex(KVIndexConfig(**cfg), device="cpu")
    for idx in (gpu, cpu):
        idx.admit(toks[:2])
    np.testing.assert_array_equal(gpu.lookup(toks), cpu.lookup(toks))
    assert gpu.bits.is_cuda
    assert torch.equal(gpu.bits.cpu(), cpu.bits)


# ---------------------------------------------------------------------------
# The slice-2 kernels: flat search, hopscotch lookup, string match.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("q,r,c", [(1, 64, 512), (130, 64, 513), (5, 33, 64),
                                   (70, 512, 300), (3000, 32, 1000)])
def test_flat_search_kernel_matches_plain(q, r, c, packed):
    """Ragged Q and C, R not a multiple of 8, all-zero mask rows, planted
    hits, int8 and packed8 planes."""
    _needs_card()
    from repro_torch.kernels.xam_search.ref import xam_search_plain
    rng = np.random.default_rng(q + r + c)
    keys = rng.integers(0, 2, (q, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    masks = (rng.random((q, r)) < 0.9).astype(np.int8)
    masks[::5] = 0
    data[:, c // 2] = keys[1 % q]
    k, m, d = (torch.from_numpy(x).cuda() for x in (keys, masks, data))
    if packed:
        d = ops.pack_rows(d)
    before = ops.FLAT_LAUNCH_COUNT
    got = ops.xam_search_device(k, d, m)
    torch.cuda.synchronize()
    assert got.is_cuda and ops.FLAT_LAUNCH_COUNT == before + 1
    assert torch.equal(got, xam_search_plain(k, d, m))
    assert bool((got[::5] == 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("window", [4, 8, 32, 33, 128])
@pytest.mark.parametrize("n_q", [1, 9, 1000])
def test_hopscotch_kernel_matches_plain(window, n_q):
    """Dense collisions (first match wins), planted hits, windows that run
    past the table's end and start below 0 (never matched outside)."""
    _needs_card()
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain
    rng = np.random.default_rng(window * n_q)
    n = window * 20 + 3
    t_lo = rng.integers(0, 4, n).astype(np.int32)
    t_hi = rng.integers(-2, 1, n).astype(np.int32)
    homes = rng.integers(-window, n, n_q).astype(np.int32)
    q_lo = rng.integers(0, 4, n_q).astype(np.int32)
    q_hi = rng.integers(-2, 1, n_q).astype(np.int32)
    homes[0], q_lo[0], q_hi[0] = 5, t_lo[7], t_hi[7]     # a planted hit
    ops_ = [torch.from_numpy(x).cuda() for x in (t_lo, t_hi, homes, q_lo,
                                                   q_hi)]
    before = hop.LAUNCH_COUNT
    got = hop.hopscotch_lookup_device(*ops_, window=window)
    torch.cuda.synchronize()
    assert hop.LAUNCH_COUNT == before + 1
    assert torch.equal(got, hopscotch_lookup_plain(*ops_, window))
    assert 0 <= int(got[0]) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(1, 1), (5000, 1), (4096 * 3 + 7, 3),
                                 (4096 * 2, 12), (20000, 4096), (10, 11),
                                 (9000, 0)])
def test_string_match_kernel_matches_plain(n, p):
    """P = 1 and P = 4096, matches across tiles, N ragged, P > N."""
    _needs_card()
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.string_match.ref import string_match_plain
    rng = np.random.default_rng(n + p)
    text = rng.integers(97, 99, n).astype(np.uint8)
    pat = rng.integers(97, 99, p).astype(np.uint8)
    for start in (4096 - p // 2, n - p):
        if 0 <= start <= n - p:
            text[start:start + p] = pat
    t, pt = torch.from_numpy(text).cuda(), torch.from_numpy(pat).cuda()
    before = sm.LAUNCH_COUNT
    got = sm.string_match(t, pt)
    torch.cuda.synchronize()
    assert sm.LAUNCH_COUNT == before + 1
    assert torch.equal(got, string_match_plain(t, pt))
    if p > n:
        assert not bool(got.any())
    elif p > 0:
        assert got[n - p] == 1


# ---------------------------------------------------------------------------
# The redesigned flat search and string match at the edges their designs
# introduce: word-count templates, 4-column vectors, ballot staging, 16-byte
# text chunks at any byte offset, the 4-byte prefix filter.
# ---------------------------------------------------------------------------

def _flat_case(rng, q, r, c):
    keys = rng.integers(0, 2, (q, r)).astype(np.int8)
    data = rng.integers(0, 2, (r, c)).astype(np.int8)
    masks = (rng.random((q, r)) < 0.95).astype(np.int8)
    masks[1::4] = 0                          # all-zero mask rows
    masks[2::4, : (r + 1) // 2] = 0          # partial masks
    for i in range(0, q, 3):                 # planted hits
        data[:, (7 * i) % c] = keys[i]
    return keys, data, masks


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("r", [1, 31, 32, 33, 64, 65, 511, 512])
def test_flat_search_edges_match_plain(r, packed):
    """R at each word-count template boundary, C = 1, 3, 513 and 1000 (the
    4-column vectors' ragged tails), Q = 1, 63, 65 and 130 (the staged
    query chunks), all-zero and partial masks."""
    _needs_card()
    from repro_torch.kernels.xam_search.ref import xam_search_plain
    rng = np.random.default_rng(r)
    for c in (1, 3, 513, 1000):
        for q in (1, 63, 65, 130):
            keys, data, masks = _flat_case(rng, q, r, c)
            k, m, d = (torch.from_numpy(x).cuda() for x in (keys, masks,
                                                            data))
            if packed:
                d = ops.pack_rows(d)
            got = ops.xam_search_device(k, d, m)
            want = xam_search_plain(k, d, m)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (q, r, c)
            if q > 1:
                assert bool((got[1] == 1).all())  # all-zero mask row


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_flat_search_unaligned_plane_view(packed):
    """A plane view whose data starts at an odd byte address: the kernel
    takes the byte-load path and still equals the plain version."""
    _needs_card()
    from repro_torch.kernels.xam_search.ref import xam_search_plain
    rng = np.random.default_rng(5)
    keys, data, masks = _flat_case(rng, 70, 64, 512)
    k, m = torch.from_numpy(keys).cuda(), torch.from_numpy(masks).cuda()
    d = torch.from_numpy(data).cuda()
    if packed:
        d = ops.pack_rows(d)
    store = torch.empty(d.numel() + 1, dtype=d.dtype, device="cuda")
    view = store[1:].view(d.shape)
    view.copy_(d)
    assert view.data_ptr() % 4 != 0 and view.is_contiguous()
    got = ops.xam_search_device(k, view, m)
    assert torch.equal(got, xam_search_plain(k, d, m))


_SM_N = 2 * 16384 + 37          # two 16 KiB tiles and a ragged tail


def _sm_text(rng, n, p, offset):
    """A two-letter text of n + offset bytes with matches planted across a
    16-byte group, across the first tile edge and at the end; returns the
    view text[offset:] and the pattern."""
    text = rng.integers(97, 99, n + offset).astype(np.uint8)
    pat = rng.integers(97, 99, p).astype(np.uint8)
    for start in (16 * 5 + 13, 16384 - p // 2, n - p):
        if 0 <= start <= n - p:
            text[offset + start:offset + start + p] = pat
    whole = torch.from_numpy(text).cuda()
    return whole[offset:], torch.from_numpy(pat).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 3, 15])
@pytest.mark.parametrize("p", [0, 1, 3, 4, 5, 15, 16, 17, 4095, 4096])
def test_string_match_edges_match_plain(p, offset):
    """Text views at byte offsets 1, 3 and 15 (unaligned 16-byte chunks),
    N not a multiple of 16, P around the 4-byte prefix filter and the
    16-position groups, P = 4095 and 4096, matches across a group and a
    tile edge."""
    _needs_card()
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.string_match.ref import string_match_plain
    t, pt = _sm_text(np.random.default_rng(p + offset), _SM_N, p, offset)
    assert t.data_ptr() % 16 == offset
    got = sm.string_match(t, pt)
    want = string_match_plain(t, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if p > 0:
        assert int(got[_SM_N - p]) == 1
        assert not bool(got[_SM_N - p + 1:].any())
    else:
        assert bool(got.all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(37, 38), (5, 4096), (16, 17)])
def test_string_match_pattern_longer_than_text(n, p):
    _needs_card()
    from repro_torch.kernels.string_match import ops as sm
    text = torch.full((n,), 97, dtype=torch.uint8, device="cuda")
    pat = torch.full((p,), 97, dtype=torch.uint8, device="cuda")
    got = sm.string_match(text, pat)
    assert got.shape == (n,) and not bool(got.any())


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 5, 64, 4096])
def test_string_match_repeated_byte(p):
    """One repeated byte: every position that fits is a match, the worst
    case for the compare loop."""
    _needs_card()
    from repro_torch.kernels.string_match import ops as sm
    from repro_torch.kernels.string_match.ref import string_match_plain
    text = torch.full((_SM_N,), 97, dtype=torch.uint8, device="cuda")[1:]
    pat = torch.full((p,), 97, dtype=torch.uint8, device="cuda")
    got = sm.string_match(text, pat)
    assert torch.equal(got, string_match_plain(text, pat))
    assert int(got.sum()) == text.shape[0] - p + 1
    assert int(sm.count_matches(text, pat)) == text.shape[0] - p + 1


# ---------------------------------------------------------------------------
# The redesigned multi-set search and hopscotch lookup at the edges their
# designs introduce (the cases of ``repro_torch.kernels.edge_cases``).
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("r", [1, 24, 33, 64, 512])
def test_multiset_edges_match_plain(r, packed):
    """R at the word-count templates' edges, C = 96, 700 (ragged) and 5000
    (column chunks, beyond the old kernel's shared memory), block_q 16 and
    100 (two staged query chunks), first matches at the 4-column vectors'
    and warps' edges, zero-mask rows beside hits, a dead block."""
    _needs_card()
    for c, block_q in ((96, 16), (700, 16), (700, 100), (5000, 16)):
        *arrays, firsts = multiset_edge_case(r + c, r, c, block_q, packed)
        operands = [torch.from_numpy(x).cuda() for x in arrays]
        got = ops.xam_search_multiset_device(*operands, block_q=block_q)
        want = xam_search_multiset_plain(*operands, block_q=block_q)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (r, c, block_q)
        got = got.cpu().numpy()
        assert got[:len(firsts) * block_q:block_q].tolist() == firsts
        assert (got[1:len(firsts) * block_q:block_q] == -1).all()
        assert (got[-2 * block_q:] == -1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_multiset_unaligned_plane_view(packed):
    """Planes and validity that start at odd byte addresses: the kernel
    takes the byte-load path and still equals the plain version."""
    _needs_card()
    *arrays, _ = multiset_edge_case(3, 64, 512, 16, packed)
    operands = [torch.from_numpy(x).cuda() for x in arrays]
    for i in (2, 3):
        t = operands[i]
        store = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        operands[i] = store[1:].view(t.shape)
        operands[i].copy_(t)
        assert operands[i].data_ptr() % 4 != 0
    got = ops.xam_search_multiset_device(*operands, block_q=16)
    assert torch.equal(got, xam_search_multiset_plain(*operands, block_q=16))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 4, 33, 128, 256])
def test_hopscotch_edges_match_plain(window):
    """H = 1 (a lane per query), 4 (a group of 4), 33 (a second step of one
    slot), 128 and 256 (four and eight steps of 32); a first hit at every
    offset, windows past N and below 0."""
    _needs_card()
    from repro_torch.kernels.hopscotch import ops as hop
    from repro_torch.kernels.hopscotch.ref import hopscotch_lookup_plain
    ops_ = [torch.from_numpy(x).cuda() for x in hop_edge_case(window,
                                                               window)]
    got = hop.hopscotch_lookup_device(*ops_, window=window)
    want = hopscotch_lookup_plain(*ops_, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[:window].tolist() == list(range(window))


@pytest.mark.gpu
def test_simulator_graph_matches_cpu():
    """The batched simulator under CUDA-graph replay on the card against
    its own eager run on the CPU: the nine §10.2 systems at 512 blocks
    (four shape families) over two traces, 1,000 requests: 15 replays of
    the 64-step graph and a 40-step eager tail run on the card.
    Stats, cycles, energy and every final-state field are equal."""
    _needs_card()
    from repro_torch.core import simulator as sim
    from repro_torch.data import traces
    from repro_torch.pytree import tree_leaves
    cfgs = sim.baseline_configs(512)
    specs = traces.crono_nas_specs(cfgs["monarch_unbound"].inpkg_blocks, 1000)
    trace_list = [(s.name, *traces.generate(s)) for s in (specs[0],
                                                          specs[-1])]
    assert sim.n_shape_families(cfgs) == 4
    assert 1000 % sim.GRAPH_STEPS != 0
    card, card_st = sim.simulate_grid(cfgs, trace_list, return_state=True,
                                      device="cuda")
    host, host_st = sim.simulate_grid(cfgs, trace_list, return_state=True,
                                      device="cpu")
    assert set(card) == set(host)
    for key, want in host.items():
        got = card[key]
        assert (got.stats, got.total_cycles, got.energy_nj) == (
            want.stats, want.total_cycles, want.energy_nj), key
        for a, b in zip(tree_leaves(card_st[key]), tree_leaves(host_st[key])):
            assert a.is_cuda and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b), key
    trace = trace_list[0]
    one = sim.simulate_trace(cfgs["monarch_m3"], *trace[1:], device="cuda")
    assert one.stats == host[("monarch_m3", trace[0])].stats


# ---------------------------------------------------------------------------
# Slice 6: gemma3's ring decode and the HTTP edge on the card.
# ---------------------------------------------------------------------------

RTOL, ATOL = 1e-2, 5e-2


def _margin_agree(got, want, gaps) -> bool:
    """Greedy tokens equal wherever the reference's top-1/top-2 gap
    exceeds 0.1."""
    return bool(((got == want) | (gaps <= 0.1)).all())


@pytest.mark.gpu
def test_ring_decode_wraps_and_matches_oracles():
    """Reduced gemma3 with 8 layers (a [local x 5, global] group and two
    local remainder blocks, window 32) on the card: prefill 40 tokens and
    decode 8 whose ring slots wrap.  Each step's logits against a
    plain-cache decode of the same tokens (local layers masked to the
    window), the greedy tokens against a fresh full prefill over prompt +
    decoded tokens under the margin rule, and the first layer's ring slot
    for slot against that prefill's."""
    _needs_card()
    import dataclasses
    from _torch_parity import plain_cache_decode
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_arch("gemma3-27b").reduced(), n_layers=8)
    params = transformer.init_params(cfg, seed=1, device="cuda")
    s, n = 40, 8
    prompt = np.random.default_rng(9).integers(1, cfg.vocab_size, (2, s))
    want, fed = plain_cache_decode(params, cfg, prompt, n)
    logits, cache = transformer.prefill(params, cfg, {"tokens": prompt},
                                        s + n)
    for t in range(n):
        logits, cache = transformer.decode_step(
            params, cfg, fed[:, t:t + 1], cache, s + t)
        assert torch.allclose(logits, want[t], rtol=RTOL, atol=ATOL), t
        seq = np.concatenate([prompt, fed[:, :t + 1].cpu().numpy()], axis=1)
        full, fcache = transformer.prefill(params, cfg, {"tokens": seq},
                                           s + n)
        top = full.topk(2, dim=-1).values
        assert _margin_agree(logits.argmax(-1), full.argmax(-1),
                             top[:, 0] - top[:, 1]), t
    ring = cache["groups"]["b0"]["k"]
    assert ring.is_cuda and ring.shape[2] == cfg.sliding_window
    assert torch.allclose(ring.float(), fcache["groups"]["b0"]["k"].float(),
                          rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_httpd_edge_on_the_card():
    """``launch/httpd.py`` booted in-process with reduced gemma3 on the
    card: a prompt and its repeat through the socket; the repeat resumes
    from slabs and decodes the same tokens, each lookup one launch."""
    _needs_card()
    import http.client
    import json
    from repro_torch.kernels.xam_search import ops as xam
    from repro_torch.launch import httpd
    args = httpd.build_parser().parse_args(
        ["--arch", "gemma3-27b", "--reduced", "--port", "0",
         "--prompt-len", "48", "--decode-tokens", "3",
         "--batch-window-ms", "0", "--admit-after-reads", "0"])
    fe, q = httpd.build_frontend(args)
    assert q.index.bits.is_cuda
    fe.start()
    before = xam.LAUNCH_COUNT
    try:
        toks = (np.arange(1, 49).reshape(1, 48) % 500 + 1).tolist()
        docs = []
        for _ in range(2):
            conn = http.client.HTTPConnection(*fe.address, timeout=120)
            conn.request("POST", "/v1/generate",
                         body=json.dumps({"tokens": toks}))
            resp = conn.getresponse()
            assert resp.status == 200
            docs.append(json.loads(resp.read()))
            conn.close()
    finally:
        fe.shutdown()
        q.close()
    assert docs[1]["hit_chunks"] == 3 and docs[1]["resumed_chunks"] == 2
    assert docs[1]["tokens"] == docs[0]["tokens"]
    assert xam.LAUNCH_COUNT - before == q.index.stats.searches == 2


# ---------------------------------------------------------------------------
# Slice 7: logical index shards and the MoE block on the card.
# ---------------------------------------------------------------------------

def _index_state(idx) -> dict:
    ws = idx.wear_state
    return {"bits": idx.bits.cpu(), "valid": idx.valid.cpu(),
            "fp_of": idx.fp_of.cpu(), "read_after": idx.read_after.cpu(),
            "set_writes": idx.set_writes.cpu(), "counter": idx.counter.cpu(),
            "window_writes": ws.window_writes.cpu(),
            "window_start": ws.window_start.cpu(),
            "locked_until": ws.locked_until.cpu(),
            "write_counter": ws.write_counter.cpu(),
            "slot_of": dict(idx.slot_of), "report": idx.wear_report()}


def _assert_state_equal(a: dict, b: dict, msg):
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), (msg, k)
        else:
            assert v == b[k], (msg, k)


@pytest.mark.gpu
@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
def test_shards_on_card_match_cpu(plane_format):
    """Phase 3c (a) at 12 ops: indexes of 1, 2 and 4 shards under
    "auto" and "fanout" on the card against a one-shard CPU index after
    every op; one search launch a lookup under "auto", one per shard
    holding queries under "fanout"."""
    _needs_card()
    from repro_torch.data.pipeline import fingerprint_blocks
    from repro_torch.serve.kv_index import KVIndexConfig, MonarchKVIndex
    cfg = dict(n_sets=8, set_ways=4, admit_after_reads=1, m_writes=1,
               window_ops=64, rotate_every=1 << 30,
               plane_format=plane_format)
    card = {(n, d): MonarchKVIndex(KVIndexConfig(n_shards=n, **cfg),
                                   dispatch=d)
            for n in (1, 2, 4) for d in ("auto", "fanout")}
    cpu = MonarchKVIndex(KVIndexConfig(**cfg), device="cpu")
    rng = np.random.default_rng(17)
    for step in range(12):
        toks = rng.integers(1, 600, (2, 96)).astype(np.int32)
        op = rng.random()
        if op < 0.6:
            fps = np.unique(fingerprint_blocks(toks, 16).ravel())
            for _ in range(2 if op < 0.4 else 1):     # a re-offer installs
                for idx in (cpu, *card.values()):
                    idx.admit_fps(fps)
        elif op < 0.9:
            want = cpu.lookup(toks)
            sets = cpu._set_of(cpu.fingerprints(toks).ravel())
            for (n, d), idx in card.items():
                before = ops.LAUNCH_COUNT
                np.testing.assert_array_equal(idx.lookup(toks), want)
                expect = (1 if d == "auto" else
                          len(np.unique(sets // idx.sets_per_part)))
                assert ops.LAUNCH_COUNT - before == expect, (n, d)
        else:
            for idx in (cpu, *card.values()):
                idx._rotate()
        want = _index_state(cpu)
        for key, idx in card.items():
            assert idx.bits.is_cuda
            _assert_state_equal(_index_state(idx), want, (step, key))
    assert cpu.stats.admissions and cpu.stats.admission_skips


@pytest.fixture
def exact_bf16_gemms():
    """bf16 GEMMs reduce in float32 on the card, as ``chip_smoke.py``
    sets them and as the CPU does."""
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    yield
    m.allow_bf16_reduced_precision_reduction = old


def _moe_cfg(**kw):
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("s", [1, 40])
def test_moe_block_on_card_matches_cpu(s, dispatch, exact_bf16_gemms):
    """Phase 3c (b) at reduced width (d_model 128, 8 experts, top-2,
    binding capacity at S = 40): the card's expert ids equal the CPU's
    where the k-th/(k+1)-th router gap exceeds 1e-6, and its outputs are
    within rtol 1e-2/atol 5e-2 of the CPU's but for at most 0.1% of them,
    none further than 0.5 — ``chip_smoke.py``'s ceilings: the outputs
    (up to ~60 at the reference's init scales) are sums of gated bf16
    expert outputs, and where they cancel, an ulp of one contribution
    that the GEMMs' accumulation order moved exceeds the bound."""
    _needs_card()
    from repro_torch.models import moe
    from repro_torch.pytree import tree_map
    cfg = _moe_cfg(moe_dispatch=dispatch, capacity_factor=0.5)
    p = moe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    p_cpu = tree_map(lambda a: a.cpu(), p)
    x = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    y, ix, _ = moe.moe_block(p, x.cuda(), cfg, return_routing=True)
    yc, ixc, probs = moe.moe_block(p_cpu, x, cfg, return_routing=True)
    top = probs.topk(cfg.top_k + 1, dim=-1).values
    decided = (top[..., -2] - top[..., -1]) > 1e-6
    assert torch.equal(ix.cpu().sort(-1).values[decided],
                       ixc.sort(-1).values[decided])
    rows = decided.all(-1)          # a near tie may move its group's drops
    assert rows.any()
    a, b = y.float().cpu()[rows], yc.float()[rows]
    diff = (a - b).abs()
    assert float((diff > ATOL + RTOL * b.abs()).float().mean()) <= 1e-3
    assert float(diff.max()) <= 0.5
    assert torch.equal(y, moe.moe_block(p, x.cuda(), cfg))   # deterministic


@pytest.mark.gpu
def test_moe_layers_on_card_match_cpu(exact_bf16_gemms):
    """Reduced qwen3-moe (4 layers) on the card and on the CPU: prefill
    40 tokens and 8 greedy decode steps (the CPU's tokens fed to both),
    finite logits, greedy tokens equal under the margin rule."""
    _needs_card()
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_map
    cfg = _moe_cfg()
    params = transformer.init_params(cfg, seed=2, device="cuda")
    params_cpu = tree_map(lambda a: a.cpu(), params)
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 40))
    lg, cache = transformer.prefill(params, cfg, {"tokens": toks}, 48)
    lc, cache_c = transformer.prefill(params_cpu, cfg, {"tokens": toks}, 48)
    for t in range(8):
        assert torch.isfinite(lg).all(), t
        top = lc.topk(2, dim=-1).values
        assert _margin_agree(lg.argmax(-1).cpu(), lc.argmax(-1),
                             top[:, 0] - top[:, 1]), t
        nxt = lc.argmax(-1)[:, None].numpy()
        lg, cache = transformer.decode_step(params, cfg, nxt, cache, 40 + t)
        lc, cache_c = transformer.decode_step(params_cpu, cfg, nxt, cache_c,
                                              40 + t)
