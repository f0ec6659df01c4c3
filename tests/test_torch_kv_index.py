"""Parity: the port's MonarchKVIndex and AdmitQueue against the JAX
reference, op by op, with exact equality of every piece of index state.

Randomized lookup/admit/rotate schedules run through both packages on the
same seeded inputs (small ``set_ways`` and ``rotate_every`` so evictions,
throttles and rotations all happen), in both plane formats and both
clocks (``"wall"`` through one fake ``now_fn`` shared by both indexes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import admit_queue as j_aq
from repro.serve import kv_index as j_kv
from repro_torch.serve import admit_queue as t_aq
from repro_torch.serve import kv_index as t_kv


def _np(x):
    return np.asarray(x)


def _assert_wear_equal(jw, tw):
    for f in dataclasses.fields(jw):
        a, b = getattr(jw, f.name), getattr(tw, f.name)
        if f.name == "offsets":
            for g in dataclasses.fields(a):
                assert int(getattr(a, g.name)) == int(getattr(b, g.name))
            continue
        want = _np(a)
        got = b.cpu().numpy()
        assert got.dtype == want.dtype, (f.name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def _assert_index_equal(ji, ti):
    np.testing.assert_array_equal(ti.bits.cpu().numpy(), _np(ji.bits))
    assert ti.bits.dtype == (torch.uint8 if _np(ji.bits).dtype == np.uint8
                             else torch.int8)
    np.testing.assert_array_equal(ti.valid.cpu().numpy(), _np(ji.valid))
    np.testing.assert_array_equal(
        ti.fp_of.cpu().numpy().view(np.uint32), _np(ji.fp_of))
    np.testing.assert_array_equal(ti.read_after.cpu().numpy(),
                                  _np(ji.read_after))
    np.testing.assert_array_equal(ti.set_writes.cpu().numpy(),
                                  _np(ji.set_writes))
    np.testing.assert_array_equal(ti.counter.cpu().numpy(), _np(ji.counter))
    for t in (ti.read_after, ti.set_writes, ti.counter, ti.fp_of):
        assert t.dtype == torch.int32
    _assert_wear_equal(ji.wear_state, ti.wear_state)
    assert dataclasses.asdict(ti.stats) == dataclasses.asdict(ji.stats)
    assert ti.slot_of == ji.slot_of
    assert ti.first_touch == ji.first_touch
    assert (ti.offset, ti.ops_total) == (ji.offset, ji.ops_total)
    np.testing.assert_array_equal(ti.valid_np, ji.valid_np)
    np.testing.assert_array_equal(ti.fp_of_np, ji.fp_of_np)
    if ji.slab_store is not None:
        assert ti.slab_store.resident_fps() == ji.slab_store.resident_fps()
        assert ti.slab_store.staged_fps() == ji.slab_store.staged_fps()
        assert ti.slab_lockstep_report() == ji.slab_lockstep_report()
    assert ti.wear_report() == ji.wear_report()


class _FakeClock:
    """One monotonic clock shared by both indexes (advanced by the test)."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pair(plane_format, clock, fingerprint="block", slabs=False,
          **overrides):
    fake = _FakeClock()
    cfg = dict(n_sets=4, set_ways=4, key_bits=32, admit_after_reads=1,
               m_writes=1, window_ops=40 if clock == "ops" else 300,
               rotate_every=13, plane_format=plane_format, clock=clock,
               fingerprint=fingerprint)
    cfg.update(overrides)
    now = fake if clock == "wall" else None
    ji = j_kv.MonarchKVIndex(
        j_kv.KVIndexConfig(**cfg), now_fn=now,
        slab_store=j_kv.KVSlabStore() if slabs else None)
    ti = t_kv.MonarchKVIndex(
        t_kv.KVIndexConfig(**cfg), now_fn=now, device="cpu",
        slab_store=t_kv.KVSlabStore() if slabs else None)
    return ji, ti, fake


def _chunk_pool(rng, n=40):
    return rng.integers(1, 200, (n, j_kv.CHUNK_TOKENS)).astype(np.int32)


def _batch(rng, pool, b=2, chunks=3):
    picks = rng.integers(0, len(pool), (b, chunks))
    return pool[picks].reshape(b, chunks * j_kv.CHUNK_TOKENS)


@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
@pytest.mark.parametrize("clock", ["ops", "wall"])
def test_index_schedule_parity(plane_format, clock):
    rng = np.random.default_rng(7)
    ji, ti, fake = _pair(plane_format, clock, slabs=True)
    pool = _chunk_pool(rng)
    for step in range(36):
        fake.t += float(rng.integers(0, 120)) * 1e-6
        op = rng.choice(["lookup", "admit", "admit_fps", "rotate"],
                        p=[0.35, 0.35, 0.25, 0.05])
        if op == "lookup":
            toks = _batch(rng, pool)
            np.testing.assert_array_equal(ti.lookup(toks), ji.lookup(toks))
        elif op == "admit":
            toks = _batch(rng, pool, b=int(rng.integers(1, 4)))
            ji.admit(toks)
            ti.admit(toks)
        elif op == "admit_fps":
            fps = np.unique(ji.fingerprints(_batch(rng, pool, b=3)))
            for fp in fps[::2]:       # half the offers carry a staged slab
                ji.slab_store.stage(int(fp), {"k": np.zeros(4, np.float32)})
                ti.slab_store.stage(int(fp), {"k": torch.zeros(4)})
            ji.admit_fps(fps)
            ti.admit_fps(fps)
        else:
            ji._rotate()
            ti._rotate()
        _assert_index_equal(ji, ti)
    s = ji.stats
    assert s.admissions and s.evictions and s.admission_skips
    assert s.throttled and s.rotations


def test_clock_rebase_parity():
    """Crossing CLOCK_REBASE_AT folds both clocks identically."""
    ji, ti, _ = _pair("int8", "ops", admit_after_reads=0)
    rng = np.random.default_rng(3)
    pool = _chunk_pool(rng)
    for idx in (ji, ti):
        idx.ops_total = j_kv.wear.CLOCK_REBASE_AT - 3
    for _ in range(3):
        toks = _batch(rng, pool)
        ji.admit(toks)
        ti.admit(toks)
        np.testing.assert_array_equal(ti.lookup(toks), ji.lookup(toks))
        _assert_index_equal(ji, ti)


@pytest.mark.parametrize("background", [False, True])
def test_admit_queue_parity(background):
    """The same submit/lookup/rotate schedule through both AdmitQueues
    leaves both indexes (and queue stats) identical.  Background mode
    flushes after each submit so the op clock sees one interleaving."""
    rng = np.random.default_rng(11)
    ji, ti, _ = _pair("int8", "ops", fingerprint="prefix", slabs=True)
    jq = j_aq.AdmitQueue(ji, background=background)
    tq = t_aq.AdmitQueue(ti, background=background)
    pool = _chunk_pool(rng, 10)
    for step in range(16):
        toks = _batch(rng, pool, b=2, chunks=2)
        np.testing.assert_array_equal(tq.lookup(toks), jq.lookup(toks))
        fps = np.unique(ji.fingerprints(toks))
        assert jq.submit_tokens(
            toks, slabs={int(f): {"k": np.zeros(2)} for f in fps})
        assert tq.submit_tokens(
            toks, slabs={int(f): {"k": torch.zeros(2)} for f in fps})
        if background:
            jq.flush()
            tq.flush()
        if step % 7 == 6:
            jq.rotate()
            tq.rotate()
        _assert_index_equal(ji, ti)
    jq.close()
    tq.close()
    _assert_index_equal(ji, ti)
    assert dataclasses.asdict(tq.stats) == dataclasses.asdict(jq.stats)
    with pytest.raises(RuntimeError):
        tq.submit(np.asarray([1], np.uint32))


def test_index_rejects_unported_paths():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_kv.MonarchKVIndex(t_kv.KVIndexConfig(n_sets=8, n_shards=2),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_kv.MonarchKVIndex(dispatch="fanout", device="cpu")


def test_index_defaults_to_the_card():
    """No device argument means CUDA: without a card that raises instead
    of dropping to the CPU."""
    if torch.cuda.is_available():
        assert t_kv.MonarchKVIndex().bits.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_kv.MonarchKVIndex()
