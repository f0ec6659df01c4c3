"""The port's launch layer: ``launch/specs.py`` against the reference's
shapes and dtypes for all 40 cells, the analytic input bytes of every
runnable cell against the reference's ``_analytic_device_bytes`` on four
meshes, the meta-device FLOP and byte counts against the same step on the
CPU, the layer-group extrapolation against a full trace,
``launch/dryrun.py``'s record, its production meshes' records on a fake
world, and the ``opt`` variants' specs against the reference's.  Every
comparison is exact."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
from jax.sharding import PartitionSpec as P

from repro import configs as r_configs
from repro.dist import sharding as r_sharding
from repro.launch import specs as r_specs
from repro.train import step as r_step

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.pytree import tree_map
from repro_torch.roofline import analysis, jaxpr_cost

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "host": (("data", "model"), (1, 1)),
    "host4": (("data", "model"), (4, 1)),
    "single": (("data", "model"), (16, 16)),
    "multi": (("pod", "data", "model"), (2, 16, 16)),
}
CELLS = [(cfg.name, shape.name) for cfg, shape, _, _ in configs.all_cells()]
RUNNABLE = [(cfg.name, shape.name)
            for cfg, shape, ok, _ in configs.all_cells() if ok]
FIVE = ["yi-9b", "gemma3-27b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
        "zamba2-2.7b"]
SMALL = {kind: ShapeConfig(f"small_{kind}", 36, 2, kind)
         for kind in ("train", "prefill", "decode")}


class _StubMesh:
    """What the reference's rules and byte count read of a mesh."""

    def __init__(self, axis_names, shape):
        self.axis_names = axis_names
        self.devices = np.empty(shape)


@functools.lru_cache(maxsize=None)
def _reference_dryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS for a
    512-device host; the flag is read when JAX's backend starts, so it is
    put back at once and this process keeps its devices."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _sig(tree):
    """{path: (shape, dtype name)} of a reference or port tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, torch.Tensor):
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
        else:
            out[path] = (tuple(t.shape), np.dtype(t.dtype).name)
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_reference(arch, shape_name):
    cfg, shape = configs.get_arch(arch), configs.get_shape(shape_name)
    r_cfg = r_configs.get_arch(arch)
    r_shape = r_configs.get_shape(shape_name)
    for name in ("train_batch_specs", "prefill_batch_specs",
                 "decode_arg_specs"):
        got = getattr(specs, name)(cfg, shape)
        assert all(t.is_meta for t in _leaves(got)), name
        assert _sig(got) == _sig(getattr(r_specs, name)(r_cfg, r_shape)), \
            name


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_and_state_specs_match_reference(arch):
    cfg, r_cfg = configs.get_arch(arch), r_configs.get_arch(arch)
    for name in ("params_shapes", "state_shapes", "bf16_params_shapes"):
        got = getattr(specs, name)(cfg)
        assert all(t.is_meta for t in _leaves(got)), name
        assert _sig(got) == _sig(getattr(r_specs, name)(r_cfg)), name


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _reference_inputs(cfg, shape, mesh):
    """The reference's ``build_cell`` argument shapes and input specs,
    without its ``NamedSharding``s (which need real devices)."""
    if shape.kind == "train":
        st = r_specs.state_shapes(cfg)
        batch = r_specs.train_batch_specs(cfg, shape)
        return (st, batch), (r_step.state_specs(st, mesh),
                             r_sharding.batch_specs(batch, mesh))
    params = r_specs.params_shapes(cfg)
    p_specs = r_sharding.param_specs(params, mesh)
    if shape.kind == "prefill":
        batch = r_specs.prefill_batch_specs(cfg, shape)
        return (params, batch), (p_specs, r_sharding.batch_specs(batch, mesh))
    cache, tok, pos = r_specs.decode_arg_specs(cfg, shape)
    tok_spec = r_sharding._guard((r_sharding.dp_axes(mesh), None), tok.shape,
                                 mesh)
    return (params, cache, tok, pos), (
        p_specs, r_sharding.cache_specs(cache, mesh), tok_spec, P())


@pytest.mark.parametrize("arch,shape_name", RUNNABLE)
def test_analytic_input_bytes_match_reference(arch, shape_name):
    ref = _reference_dryrun()
    assert jax.device_count() == 1     # the reference's flag did not stick
    cfg, shape = configs.get_arch(arch), configs.get_shape(shape_name)
    r_cfg = r_configs.get_arch(arch)
    r_shape = r_configs.get_shape(shape_name)
    for names, mesh_shape in MESHES.values():
        r_mesh, mesh = _StubMesh(names, mesh_shape), Mesh(names, mesh_shape)
        _, args, in_specs, _ = dryrun.build_cell(cfg, shape, mesh)
        want = ref._analytic_device_bytes(
            *_reference_inputs(r_cfg, r_shape, r_mesh), r_mesh)
        assert dryrun.analytic_input_bytes_per_device(
            args, in_specs, mesh) == want, mesh_shape


def _on_cpu(tree, vocab: int):
    """Seeded CPU tensors in place of a tree's meta leaves."""
    gen = torch.Generator().manual_seed(0)

    def one(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen,
                             dtype=t.dtype)

    def walk(t):
        if isinstance(t, dict):
            return tree_map(one, t)
        if isinstance(t, tuple):
            return tuple(walk(x) for x in t)
        return one(t)
    return walk(tree)


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", FIVE)
def test_meta_counts_equal_cpu_counts(arch, kind):
    """The dry run's meta count (shape cache on, one
    ``jaxpr_cost.RankCostMode``) equals the same step's count on CPU
    tensors under ``FlopCounterMode``, ``ByteCounterMode`` and
    ``MemoryCounterMode``: FLOPs, bytes and the memory analysis's
    argument, output, alias, temporary and peak bytes."""
    cfg, shape = configs.get_arch(arch).reduced(), SMALL[kind]
    mesh = Mesh(("data", "model"), (1, 1))
    meta = dryrun._counted(cfg, shape, mesh, jaxpr_cost.MetaShapeCache())
    fn, args, _, _ = dryrun.build_cell(cfg, shape, mesh)
    args = _on_cpu(args, cfg.vocab_size)
    memory = jaxpr_cost.MemoryCounterMode(args)
    with FlopCounterMode(display=False) as flops, \
            jaxpr_cost.ByteCounterMode() as nbytes, memory:
        out = fn(*args)
    assert meta[0] > 0 and meta[4]["peak_bytes"] > meta[4]["argument_bytes"]
    assert meta[:2] == (flops.get_total_flops(), nbytes.total)
    assert meta[4] == memory.result(out)


# layers that give the reduced configs four groups or more (the count
# extrapolates from two and three) and, for gemma3 and zamba2, remainder
# blocks
DEEP = {"gemma3-27b": 26, "zamba2-2.7b": 13}


def _deep(arch):
    cfg = configs.get_arch(arch).reduced()
    return dataclasses.replace(cfg, n_layers=DEEP.get(arch, cfg.n_layers))


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", FIVE)
def test_group_extrapolation_equals_full_trace(arch, kind, monkeypatch):
    cfg, shape = _deep(arch), SMALL[kind]
    assert cfg.scan_groups()[1] >= 4 and (arch not in DEEP
                                          or cfg.scan_groups()[2])
    mesh = Mesh(("data", "model"), (1, 1))
    monkeypatch.setattr(dryrun, "TRACE_BUDGET_S", 0.0)
    ext = dryrun.count_step(cfg, shape, mesh)
    full = dryrun._counted(cfg, shape, mesh, jaxpr_cost.MetaShapeCache())
    assert ext["flops_method"] == ext["memory_method"] == \
        "group_extrapolated"
    assert (ext["flops"], ext["hbm_bytes"]) == full[:2]
    assert ext["memory"] == full[4]


def _assert_memory_record(mem, want=None):
    """A record's memory fields: the reference's keys (integers but the
    code bytes, null with its reason), the aliases and the peak, the
    analytic input bytes, and fits by inputs and by peak (null without a
    card); ``want`` the count's figures."""
    keys = ("argument_bytes", "output_bytes", "alias_bytes", "temp_bytes",
            "peak_bytes")
    assert all(type(mem[k]) is int for k in keys), mem
    if want is not None:
        assert {k: mem[k] for k in keys} == want
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == max(0, mem["peak_bytes"]
                                    - mem["argument_bytes"]
                                    - mem["output_bytes"]
                                    + mem["alias_bytes"])
    assert mem["generated_code_bytes"] is None
    assert "no compiled program" in mem["generated_code_bytes_note"]
    assert mem["memory_method"] in ("traced", "group_extrapolated")
    assert "temp_bytes_note" not in mem
    assert mem["inputs_exceed_card"] is mem["peak_exceeds_card"] is None


def test_run_cell_writes_its_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun.configs, "get_arch",
                        lambda name: configs.ARCHS[name].reduced())
    dryrun.main(["--arch", "zamba2-2.7b", "--shape", "decode_32k",
                 "--n-devices", "1", "--out", str(tmp_path)])
    path = tmp_path / "host__zamba2-2.7b__decode_32k.json"
    rec = json.loads(path.read_text())
    cfg = configs.ARCHS["zamba2-2.7b"].reduced()
    shape = configs.get_shape("decode_32k")
    mesh = Mesh(("data", "model"), (1, 1))
    _, args, in_specs, _ = dryrun.build_cell(cfg, shape, mesh)
    assert rec["runnable"] and rec["n_devices"] == 1
    assert rec["memory"]["analytic_input_bytes_per_device"] == \
        dryrun.analytic_input_bytes_per_device(args, in_specs, mesh)
    assert rec["memory"]["card_bytes"] is None          # no card here
    count = dryrun.count_step(cfg, shape, mesh)
    _assert_memory_record(rec["memory"], count["memory"])
    assert rec["memory"]["memory_method"] == "traced"
    assert rec["flops"] == count["flops"]
    assert rec["collectives"] == {"total": 0}
    assert rec["roofline"]["flops"] == rec["flops"]
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert rec["flops_method"] == "traced" and rec["trace_s"] > 0
    # a skipped cell records its reason and runs nothing
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k", out_dir=str(
        tmp_path))
    assert not skip["runnable"] and "encoder-only" in skip["skip_reason"]


#: (mesh, arch, shape) of the production-mesh records: every mesh, a
#: model-parallel prefill and decode cell, the experts over ``model``,
#: and zamba2's SSM decode with its shared attention's cache split by
#: sequence; the archs reduced (a train cell's step is
#: ``test_torch_mesh_train.py``'s fake-world case)
PRODUCTION_CELLS = [("single", "yi-9b", "prefill_32k"),
                    ("multi", "qwen3-moe-30b-a3b", "decode_32k"),
                    ("optsingle", "yi-9b", "decode_32k"),
                    ("optmulti", "zamba2-2.7b", "long_500k")]
_RUN_CELL = """
import sys
from repro_torch import configs
from repro_torch.launch import dryrun
dryrun.configs.get_arch = lambda name: configs.ARCHS[name].reduced()
dryrun.main(sys.argv[1:])
"""


@pytest.mark.parametrize("mesh_kind,arch,shape_name", PRODUCTION_CELLS)
def test_production_mesh_record(mesh_kind, arch, shape_name, tmp_path):
    """``launch/dryrun.py --mesh`` on a production mesh, in a process of
    its own (the fake world's group dies with it): the reference's file
    name and record keys, rank 0's counts, collective bytes by the
    reference's kinds, none of them 0 in total."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_CELL, "--arch", arch, "--shape",
         shape_name, "--mesh", mesh_kind, "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    path = tmp_path / f"{mesh_kind}__{arch}__{shape_name}.json"
    rec = json.loads(path.read_text())
    assert {"n_devices", "memory", "flops", "hbm_bytes", "collectives",
            "roofline"} <= set(rec)
    names, shape = MESHES["multi" if "multi" in mesh_kind else "single"]
    mesh = Mesh(names, shape)
    assert rec["n_devices"] == mesh.size
    cfg = configs.ARCHS[arch].reduced()
    _, args, in_specs, _ = dryrun.build_cell(
        cfg, configs.get_shape(shape_name), mesh, mesh_kind.startswith("opt"))
    assert rec["memory"]["analytic_input_bytes_per_device"] == \
        dryrun.analytic_input_bytes_per_device(args, in_specs, mesh)
    _assert_memory_record(rec["memory"])
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    coll = rec["collectives"]
    assert list(coll) == list(analysis.COLLECTIVES) + ["total"]
    assert coll["total"] == sum(coll[k] for k in analysis.COLLECTIVES) > 0
    assert rec["roofline"]["coll_bytes"] == coll["total"]
    assert f"x {mesh_kind}: inputs" in proc.stdout
    assert "GB/device, peak" in proc.stdout


def _spec_tuples(tree):
    """A spec tree's leaves as plain tuples, by path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = tuple(t)
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", FIVE)
def test_opt_decode_specs_match_reference(arch):
    """``opt`` decode: the parameters by ``param_specs(two_d_mlp=True)``
    and the cache by ``cache_specs(seq_shard=True)``, leaf for leaf the
    reference's on both production meshes."""
    cfg, r_cfg = configs.get_arch(arch), r_configs.get_arch(arch)
    shape = configs.get_shape("decode_32k")
    for names, mesh_shape in (MESHES["single"], MESHES["multi"]):
        mesh, r_mesh = Mesh(names, mesh_shape), _StubMesh(names, mesh_shape)
        _, _, (p_specs, c_specs, _, _), _ = dryrun.build_cell(
            cfg, shape, mesh, opt=True)
        cache, _, _ = r_specs.decode_arg_specs(r_cfg, r_configs.get_shape(
            "decode_32k"))
        assert _spec_tuples(p_specs) == _spec_tuples(r_sharding.param_specs(
            r_specs.params_shapes(r_cfg), r_mesh, two_d_mlp=True))
        assert _spec_tuples(c_specs) == _spec_tuples(r_sharding.cache_specs(
            cache, r_mesh, seq_shard=True))


def test_step_bytes_of_a_matmul():
    m, k, n = 96, 64, 80
    a = torch.empty((m, k), dtype=torch.bfloat16, device="meta")
    b = torch.empty((k, n), dtype=torch.bfloat16, device="meta")
    mm = lambda x, y: x @ y
    assert jaxpr_cost.step_bytes(mm, a, b) == 2 * (m * k + k * n + m * n)
    assert jaxpr_cost.step_cost(mm, a, b) == (2 * m * k * n,
                                              2 * (m * k + k * n + m * n))
    # views and metadata ops move nothing
    assert jaxpr_cost.step_bytes(lambda x: x.t()[:5].unsqueeze(0), a) == 0


def test_meta_shape_cache_answers_repeats():
    x = torch.empty((4, 8), device="meta")
    with jaxpr_cost.MetaShapeCache() as cache:
        outs = [torch.addcmul(x, x, x) for _ in range(3)]
        # a factory on the CPU runs as it is: its value can be read
        scale = float(torch.tensor(2.0, dtype=torch.bfloat16))
    assert scale == 2.0
    assert len(cache._outputs) == 1
    assert all(o.is_meta and o.shape == (4, 8) for o in outs)
    assert len({id(o) for o in outs}) == 3
