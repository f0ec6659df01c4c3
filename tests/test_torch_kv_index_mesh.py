"""Parity: the port's partitioned index — the ``("sets",)`` mesh of
``launch/mesh.py``, the stacked search, the per-partition round-grid
admission and the boundary-exchange rotation — against the JAX reference.

The port drives ``devices=("cpu",) * n`` as the reference drives
``--xla_force_host_platform_device_count=n``: one process, one partition
per device.  Every case holds the partitioned ``"auto"`` index, after
every op, to its one-partition self, to the ``"fanout"`` oracle, and to
the reference's in-process twins (one device there); one case holds it to
the reference's own four-device run, whose ``shard_map`` search and
admission and ``ppermute`` roll a subprocess drives
(``tests/_ref_mesh_dump.py``).  Equality is exact: planes, counters,
wear state, hits, stats, shadow map and wear report.  Fixed seeds.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _ref_mesh_dump as dump_mod
from repro.data.pipeline import fingerprint_blocks
from repro.kernels.xam_search import ops as j_ops
from repro.serve import kv_index as j_kv
from repro_torch.kernels.common import unpack_bits_np
from repro_torch.kernels.xam_search import ops as t_ops
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.serve import index_placement
from repro_torch.serve import admit_queue as t_aq
from repro_torch.serve import kv_index as t_kv
from test_torch_kv_index import _assert_index_equal
from test_torch_kv_index_sharded import _assert_same, _cfg, _state

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = t_kv.CHUNK_TOKENS
PART_COUNTS = (1, 2, 4)


def _port(n: int, dispatch: str = "auto", devices=None, **kw):
    return t_kv.MonarchKVIndex(
        t_kv.KVIndexConfig(**_cfg(n, **kw)), dispatch=dispatch,
        device="cpu", devices=("cpu",) * n if devices is None else devices)


class _Mesh:
    """The partitioned port index beside its one-partition self, the port's
    and the reference's fanout oracles, and the reference's auto index."""

    def __init__(self, n: int, **kw):
        cfg = _cfg(n, **kw)
        self.auto = _port(n, **kw)
        self.one = _port(n, devices=("cpu",), **kw)
        self.fan = _port(n, "fanout", **kw)
        self.j_auto = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**cfg))
        self.j_fan = j_kv.MonarchKVIndex(j_kv.KVIndexConfig(**cfg),
                                         dispatch="fanout")
        assert self.auto.n_parts == n and self.one.n_parts == 1

    def all(self):
        return (self.auto, self.one, self.fan, self.j_auto, self.j_fan)

    def admit_fps(self, fps):
        for idx in self.all():
            idx.admit_fps(fps)

    def lookup(self, toks):
        hits = [idx.lookup(toks) for idx in self.all()]
        for h in hits[1:]:
            np.testing.assert_array_equal(hits[0], h)
        return hits[0]

    def rotate(self):
        for idx in self.all():
            idx._rotate()

    def check(self, msg: str):
        _assert_index_equal(self.j_auto, self.auto)
        _assert_index_equal(self.j_fan, self.fan)
        ref = _state(self.auto)
        _assert_same(ref, _state(self.one), f"{msg}: one partition")
        _assert_same(ref, _state(self.fan), f"{msg}: fanout")


def _schedule(rng, m: _Mesh, steps: int):
    """Seeded batches in a fixed cycle of ops: admit with a re-offer
    (which crosses the no-allocate gate), look that batch up (hits),
    admit once, look up fresh tokens, rotate."""
    seen = None
    for step in range(steps):
        toks = rng.integers(1, 600, (2, 6 * CHUNK)).astype(np.int32)
        kind = step % 5
        if kind in (0, 2):
            fps = np.unique(fingerprint_blocks(toks, CHUNK).reshape(-1))
            m.admit_fps(fps)
            if kind == 0:
                m.admit_fps(fps)
                seen = toks
        elif kind in (1, 3):
            m.lookup(seen if kind == 1 else toks)
        else:
            m.rotate()
        m.check(f"step {step}")


@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
@pytest.mark.parametrize("n", PART_COUNTS)
def test_auto_step_trace_over_partitions(n, plane_format):
    """tests/test_kv_index_differential.py's step trace with the auto
    index partitioned over ``("cpu",) * n``: equal to its one-partition
    self, both fanout oracles and the reference after every op; every
    trace crosses a rotation and hits."""
    m = _Mesh(n, plane_format=plane_format)
    _schedule(np.random.default_rng(10 + n), m, 12)
    m.rotate()
    m.check("final rotate")
    s = m.auto.stats
    assert s.admissions and s.rotations and s.chunk_hits, s


@pytest.mark.parametrize("plane_format", ["int8", "packed8"])
@pytest.mark.parametrize("n", [2, 4])
def test_boundary_straddle_after_rotation(n, plane_format):
    """Residents in every partition-edge set pushed across the edges by
    repeated set+7 boundary exchanges: residency survives, and the
    stacked search (per-partition lists, and the flattened launch over
    the global planes) agrees with the fanout search and the
    reference's."""
    m = _Mesh(n, admit_after_reads=0, set_ways=16, plane_format=plane_format)
    auto = m.auto
    s_part = auto.cfg.n_sets // n
    fps = np.arange(1, 257, dtype=np.uint32)
    m.admit_fps(fps)
    edge = {b for k in range(n) for b in (k * s_part, (k + 1) * s_part - 1)}
    assert {int(s) for s, _ in auto.slot_of.values()} >= edge
    key_bits = t_ops.words_to_bits_np(fps, auto.cfg.key_bits)
    for rot in range(3):
        m.rotate()
        m.check(f"rot {rot}")
        sets = auto._set_of(fps)
        ways = t_ops.xam_search_multiset_stacked(key_bits, sets, auto._bits,
                                                 auto._valid)
        resident = np.asarray([int(f) in auto.slot_of for f in fps])
        np.testing.assert_array_equal(ways >= 0, resident)
        flat = t_ops.xam_search_multiset_stacked(
            key_bits, sets, auto.bits, auto.valid, n_parts=n)
        np.testing.assert_array_equal(flat, ways)
        fan = t_ops.xam_search_multiset_sharded(key_bits, sets, m.fan._bits,
                                                m.fan._valid)
        np.testing.assert_array_equal(fan, ways)
        want = j_ops.xam_search_multiset_sharded(
            key_bits, sets, m.j_fan._bits, m.j_fan._valid)
        np.testing.assert_array_equal(ways, np.asarray(want))
    assert auto.stats.rotations == 3


def _unpacked(idx) -> dict:
    st = _state(idx)
    if st["bits"].dtype == np.uint8:
        st["bits"] = unpack_bits_np(st["bits"], idx.cfg.key_bits, axis=1)
    return st


@pytest.mark.parametrize("n", [2, 4])
def test_packed_against_int8_over_partitions(n):
    """A packed8 and an int8 index, both partitioned, through one
    schedule: equal hits and state after every op (planes unpacked),
    rotations included — the boundary exchange moves packed words."""
    packed = _port(n, admit_after_reads=0, set_ways=4, m_writes=1,
                   window_ops=64, plane_format="packed8")
    plain = _port(n, admit_after_reads=0, set_ways=4, m_writes=1,
                  window_ops=64, plane_format="int8")
    assert packed.bits.dtype == torch.uint8 and plain.bits.dtype == torch.int8
    rng = np.random.default_rng(n)
    for step in range(12):
        toks = rng.integers(1, 400, (2, 6 * CHUNK)).astype(np.int32)
        fps = np.unique(fingerprint_blocks(toks, CHUNK).reshape(-1))
        packed.admit_fps(fps)
        plain.admit_fps(fps)
        np.testing.assert_array_equal(packed.lookup(toks), plain.lookup(toks))
        if step % 3 == 2:
            packed._rotate()
            plain._rotate()
        _assert_same(_unpacked(packed), _unpacked(plain), f"step {step}")
    s = plain.stats
    assert s.evictions and s.throttled and s.rotations == 4


@pytest.mark.parametrize("n", PART_COUNTS)
def test_one_search_per_lookup_and_admission(n):
    """A lookup is one search (one grouping) and one multi-set launch per
    partition, partitions without queries included; an admission is one
    dispatch.  Each partition's tensors live on its device."""
    idx = _port(n, admit_after_reads=0)
    assert idx.n_parts == n and (idx.set_mesh is None) == (n == 1)
    for parts in (idx._bits, idx._valid, idx._fp_of, idx._read_after,
                  idx._set_writes, idx._counters):
        assert len(parts) == n and all(p.device.type == "cpu"
                                       for p in parts)
    rng = np.random.default_rng(0)
    for _ in range(3):
        fps = np.unique(rng.integers(1, 3000, 24).astype(np.uint32))
        before = t_ops.ADMIT_LAUNCH_COUNT
        idx.admit_fps(fps)
        assert t_ops.ADMIT_LAUNCH_COUNT == before + 1
    toks = np.full((1, CHUNK), 5, np.int32)     # one chunk: one partition
    for probe in (toks, rng.integers(1, 50_000, (4, 256)).astype(np.int32)):
        before, searches = t_ops.LAUNCH_COUNT, idx.stats.searches
        idx.lookup(probe)
        assert t_ops.LAUNCH_COUNT == before + n
        assert idx.stats.searches == searches + 1
    assert idx.stats.admit_calls == 3


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_sharded_roll_matches_torch_roll(n_parts):
    """``make_sharded_roll`` of per-partition lists equals ``torch.roll``
    of their concatenation, for every shift in (0, n_sets), on 3-D int8
    and 2-D int32 planes at once; the old blocks stay untouched."""
    n_sets = 24
    mesh = t_mesh.Mesh(("sets",), (n_parts,), (torch.device("cpu"),) *
                       n_parts)
    gen = torch.Generator().manual_seed(n_parts)
    planes = torch.randint(0, 2, (n_sets, 5, 3), generator=gen,
                           dtype=torch.int8)
    fp = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_sets, 3), generator=gen,
                       dtype=torch.int32)
    split = lambda x: list(x.clone().chunk(n_parts))
    for shift in range(1, n_sets):
        old_p, old_f = split(planes), split(fp)
        new_p, new_f = t_mesh.make_sharded_roll(mesh, n_sets, shift)(
            old_p, old_f)
        for new, x in ((new_p, planes), (new_f, fp)):
            assert len(new) == n_parts
            assert torch.equal(torch.cat(new), torch.roll(x, shift, 0)), shift
        assert torch.equal(torch.cat(old_p), planes)


def test_mesh_functions():
    """``set_partitions`` / ``set_shard_devices`` / ``make_grid_mesh``:
    coarsening, contiguous blocks, None for one device."""
    cpu = ("cpu",)
    assert [t_mesh.set_partitions(n, cpu * 4) for n in range(1, 9)] == \
        [1, 2, 3, 4, 1, 3, 1, 4]
    assert t_mesh.make_set_mesh(4, cpu) is None
    m = t_mesh.make_set_mesh(8, cpu * 3)
    assert m.shape == (2,) and m.devices == (torch.device("cpu"),) * 2
    assert t_mesh.make_grid_mesh(6, cpu * 3).shape == (3,)
    assert t_mesh.make_grid_mesh(7, cpu * 3) is None
    assert t_mesh.make_grid_mesh(4, cpu) is None
    assert t_mesh.default_devices("cpu") == (torch.device("cpu"),)
    blocks = t_mesh.set_axis_sharding(m, torch.arange(6))
    assert [b.tolist() for b in blocks] == [[0, 1, 2], [3, 4, 5]]
    rep = t_mesh.replicated_sharding(m, torch.ones(2))
    assert list(rep) == [torch.device("cpu")]
    # three devices hold two partitions of four shards, the fanout oracle
    # places shards in contiguous blocks over them
    idx = _port(4, devices=cpu * 3)
    assert idx.n_parts == 2 and idx.sets_per_part == 4
    assert "2 partitions on cpu, cpu" in index_placement(idx)
    assert "co-located" in index_placement(_port(4, devices=cpu))


def test_global_views_resplit_onto_partitions():
    """The getter concatenates on partition 0's device; the setter splits
    a global tensor into one block per partition."""
    idx = _port(4)
    idx.valid = torch.arange(8 * 8, dtype=torch.int8).reshape(8, 8)
    assert len(idx._valid) == 4 and idx._valid[3][1, 0] == 7 * 8
    assert idx.valid.device == idx.device == torch.device("cpu")
    assert tuple(idx.wear_state.window_writes.shape) == (8,)


def test_no_plane_data_through_the_host(monkeypatch):
    """Inside a partition's admission scan and inside a rotation no
    tensor goes to numpy or the host (``Tensor.numpy``, ``.cpu``,
    ``.tolist``, ``.item``, truth and int conversion all raise)."""
    active = [False]
    for name in ("numpy", "cpu", "tolist", "item", "__bool__", "__int__"):
        orig = getattr(torch.Tensor, name)

        def guarded(self, *a, _orig=orig, _name=name, **kw):
            if active[0]:
                raise AssertionError(f"Tensor.{_name} on a device path")
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, guarded)

    def inside(fn):
        def run(*a, **kw):
            active[0] = True
            try:
                return fn(*a, **kw)
            finally:
                active[0] = False
        return run

    active[0] = True
    with pytest.raises(AssertionError, match="device path"):
        torch.ones(2).cpu()
    active[0] = False
    monkeypatch.setattr(t_kv, "_admit_round", inside(t_kv._admit_round))
    idx, twin = _port(4, admit_after_reads=0), _port(4, devices=("cpu",),
                                                     admit_after_reads=0)
    fps = np.arange(1, 97, dtype=np.uint32)
    for x in (idx, twin):
        x.admit_fps(fps)
        x.admit_fps(fps[::3])
    inside(idx._rotate)()
    inside(idx._rotate)()
    twin._rotate()
    twin._rotate()
    _assert_same(_state(idx), _state(twin), "guarded")
    assert idx.stats.admissions > 0 and idx.stats.rotations == 2


@pytest.mark.parametrize("background", [False, True])
def test_queue_over_partitions_matches_inline(background):
    """An ``AdmitQueue`` (worker thread) over a partitioned index leaves
    it equal to inline admission into a one-partition index."""
    kw = dict(n_sets=8, set_ways=16, admit_after_reads=1)
    queued, inline = _port(4, **kw), _port(4, devices=("cpu",), **kw)
    q = t_aq.AdmitQueue(queued, background=background)
    rng = np.random.default_rng(3)
    batches = [np.unique(rng.integers(1, 400, 24).astype(np.uint32))
               for _ in range(5)]
    for fps in batches + batches[:2]:
        q.submit(fps)
        inline.admit_fps(fps)
    q.flush()
    q.close()
    _assert_same(_state(inline), _state(queued), "queue")


def test_reference_shard_map_run_replayed(tmp_path):
    """The reference over four forced host devices (its ``shard_map``
    search and admission, its ``ppermute`` roll; run in a subprocess)
    against the port over ``("cpu",) * 4``: the same state after every
    op of one schedule, int8 and packed8, and the same partition counts
    and shard placement for 1 to 8 shards."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, str(ROOT / "tests" / "_ref_mesh_dump.py"),
                    str(out)], env=env, check=True, timeout=120)
    d = np.load(out)
    cpu4 = ("cpu",) * 4
    np.testing.assert_array_equal(
        d["set_partitions"], [t_mesh.set_partitions(n, cpu4)
                              for n in range(1, 9)])
    ids = t_mesh.Mesh(("sets",), (4,), (0, 1, 2, 3))
    for n in range(1, 9):
        mesh = (None if t_mesh.make_set_mesh(n, cpu4) is None else
                t_mesh.Mesh(("sets",), (t_mesh.set_partitions(n, cpu4),),
                            ids.devices[:t_mesh.set_partitions(n, cpu4)]))
        got = t_mesh.set_shard_devices(mesh, n)
        np.testing.assert_array_equal(d[f"shard_devices_{n}"],
                                      [-1] if got is None else got)
    n_ops = len([k for k in d.files if k.startswith("op_")])
    for fmt in dump_mod.FORMATS:
        idx = t_kv.MonarchKVIndex(t_kv.KVIndexConfig(
            plane_format=fmt, **dump_mod.CFG), device="cpu", devices=cpu4)
        assert idx.n_parts == 4
        for i in range(n_ops):
            op, payload = int(d[f"op_{i}"]), d[f"payload_{i}"]
            if op in (0, 1):
                for _ in range(op + 1):
                    idx.admit_fps(payload)
            elif op == 2:
                np.testing.assert_array_equal(idx.lookup(payload),
                                              d[f"{fmt}_hits_{i}"])
            else:
                idx._rotate()
            got = dump_mod.state_of(_HostView(idx))
            for key, v in got.items():
                np.testing.assert_array_equal(
                    v, d[f"{fmt}_{i}_{key}"], err_msg=f"{fmt} op {i} {key}")
        assert idx.stats.admissions and idx.stats.chunk_hits


class _HostView:
    """The port index seen through numpy, as ``_ref_mesh_dump.state_of``
    reads the reference's (``np.asarray`` of each plane and wear field;
    the fingerprint plane as uint32)."""

    def __init__(self, idx):
        self._idx = idx
        for name in ("bits", "valid", "read_after", "set_writes",
                     "counter"):
            setattr(self, name, getattr(idx, name).numpy())
        self.fp_of = idx.fp_of.numpy().view(np.uint32)
        ws = idx.wear_state
        self.wear_state = type("W", (), {
            f: getattr(ws, f).numpy() for f in (
                "swt_w", "swt_d", "window_writes", "window_start",
                "locked_until", "write_counter", "superset_counter",
                "dirty_counter")})
        self.stats, self.offset = idx.stats, idx.offset
        self.ops_total, self.slot_of = idx.ops_total, idx.slot_of

    def wear_report(self):
        return self._idx.wear_report()
