"""Dry run (port of ``repro/launch/dryrun.py``).

For an (architecture x input-shape) cell on a mesh, the cell's step
(train, prefill or decode) is built over ``meta`` inputs
(``launch/specs.py``) and run once under the counters
(``roofline/jaxpr_cost.py``).  Nothing is allocated and nothing is
compiled, so a full configuration that does not fit a card is still
described.  The record, JSON ``{mesh}__{arch}__{shape}.json`` under
``build/dryrun/`` by default, holds the inputs' bytes per device, the
counted FLOPs and bytes, the collective bytes by kind and the roofline
terms on the machine profile (``h100-sxm`` on an H100).  Run one cell:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k [--mesh host|single|multi|optsingle|optmulti]

or every cell, each in a fresh process (on a host without a card, add
``--n-devices 1`` to describe a one-card host mesh):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh ...]

The meshes:

* ``host`` (the default) is this host's cards
  (``launch/mesh.make_host_mesh``), one process: the step runs on plain
  ``meta`` tensors, its global FLOPs and bytes are counted
  (``FlopCounterMode``, ``ByteCounterMode``) and divided by the device
  count, as the reference divides its counted step's, and there are no
  collectives.
* ``single`` and ``multi`` are the reference's production meshes, 16 x
  16 ``("data", "model")`` and 2 x 16 x 16 ``("pod", "data",
  "model")``; ``optsingle`` and ``optmulti`` add its ``opt`` variants
  (sequence-sharded attention in train and prefill; ``two_d_mlp``
  weights and a sequence-sharded cache in decode).  This process stands
  in for rank 0 of a fake world of 256 or 512 ranks
  (``launch/mesh.fake_world``): the inputs are placed by the specs as
  ``DTensor``s of ``meta`` blocks, and the step runs as rank 0 would
  run it, under ``jaxpr_cost.RankCostMode``.  So the record's FLOPs and
  bytes are rank 0's own, counted on its local shapes (replicated work
  included), not the global count divided by the device count; its
  ``collectives`` are the output bytes of the collectives rank 0
  issues (``analysis.CollectiveCounter``), by the reference's kinds.
  The collectives are those DTensor's rules and the port's own layouts
  choose, not XLA's.

What else differs from the reference:

* There are no compiler temp bytes (``compiled.memory_analysis()``): the
  record's ``temp_bytes`` is null.  The analytic input bytes are a lower
  bound on the peak memory, not the peak.
* FLOPs count what runs, so every loop trip is traced.  Where a
  full-depth trace would take more than :data:`TRACE_BUDGET_S`, the step
  is counted at one and two layer groups (with the remainder blocks as
  they are) and extrapolated linearly to the full depth: every group of
  a config is the same computation, so this is exact
  (``flops_method``: ``"traced"`` or ``"group_extrapolated"``); the
  collective bytes extrapolate the same way, as the reference multiplies
  a loop body's by its trip count.
* A decode step runs at the cache's last position: the work does not
  depend on it (every slot is attended under a mask).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import specs as lspecs
from repro_torch.launch.mesh import (device_mesh, fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer
from repro_torch.roofline import analysis, jaxpr_cost
from repro_torch.serve import step as serve_step_mod
from repro_torch.train import step as train_step_mod

OUT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"))
#: Seconds a full-depth trace may be expected to take before the count is
#: extrapolated from one and two layer groups (the estimate runs up to a
#: third low; the extrapolation is exact).
TRACE_BUDGET_S = 1.0
PRODUCTION_MESHES = ("single", "multi", "optsingle", "optmulti")


def analytic_input_bytes_per_device(shapes, specs, mesh) -> int:
    """Per-device bytes of the sharded inputs: each leaf's bytes over the
    product of the mesh axes its spec names (the reference's
    ``_analytic_device_bytes``)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))

    def one(leaf, spec):
        denom = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= sizes.get(a, 1)
        return leaf.numel() * leaf.element_size() // max(denom, 1)

    def walk(sh, sp):
        if isinstance(sh, dict):
            return sum(walk(sh[k], sp[k]) for k in sh)
        if isinstance(sh, (tuple, list)):
            return sum(walk(a, b) for a, b in zip(sh, sp))
        return one(sh, sp)

    return walk(shapes, specs)


def _logits_spec(cfg: ArchConfig, shape: ShapeConfig, mesh):
    dp = sharding.dp_axes(mesh)
    return sharding._guard((dp, "model"),
                           (shape.global_batch, cfg.vocab_size), mesh)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, opt: bool = False):
    """``(fn, args, in_specs, out_specs)``: the cell's step, its ``meta``
    arguments and their spec trees.  The steps update their state or
    cache in place, where the reference donates it.  ``opt`` is the
    reference's variant: sequence-sharded attention in train and
    prefill, ``two_d_mlp`` weights and a sequence-sharded cache in
    decode."""
    if opt and shape.kind in ("train", "prefill") \
            and not cfg.is_attention_free:
        dp = sharding.dp_axes(mesh)
        cfg = dataclasses.replace(
            cfg, attn_seq_shard=dp if isinstance(dp, tuple) else (dp,))
    if shape.kind == "train":
        state_sh = lspecs.state_shapes(cfg)
        batch_sh = lspecs.train_batch_specs(cfg, shape)
        st_specs = train_step_mod.state_specs(state_sh, mesh)
        b_specs = sharding.batch_specs(batch_sh, mesh)
        fn = train_step_mod.make_train_step(cfg)
        return fn, (state_sh, batch_sh), (st_specs, b_specs), (st_specs, ())

    params_sh = lspecs.params_shapes(cfg)
    p_specs = sharding.param_specs(params_sh, mesh)
    if shape.kind == "prefill":
        batch_sh = lspecs.prefill_batch_specs(cfg, shape)
        b_specs = sharding.batch_specs(batch_sh, mesh)
        if cfg.encoder_only:
            @torch.no_grad()
            def fn(params, batch):  # encoder forward IS the prefill
                return transformer.forward(params, cfg, batch)
            out_specs = ()
        else:
            fn = torch.no_grad()(serve_step_mod.make_prefill_step(
                cfg, shape.seq_len))
            cache_sh = transformer.init_cache(cfg, shape.global_batch,
                                              shape.seq_len, device="meta")
            out_specs = (_logits_spec(cfg, shape, mesh),
                         sharding.cache_specs(cache_sh, mesh))
        return fn, (params_sh, batch_sh), (p_specs, b_specs), out_specs

    # decode
    p_specs = sharding.param_specs(params_sh, mesh, two_d_mlp=opt)
    cache_sh, tok_sh, pos_sh = lspecs.decode_arg_specs(cfg, shape)
    c_specs = sharding.cache_specs(cache_sh, mesh, seq_shard=opt)
    tok_spec = sharding._guard((sharding.dp_axes(mesh), None),
                               tok_sh.shape, mesh)
    step = serve_step_mod.make_decode_step(cfg)
    last = shape.seq_len - 1

    @torch.no_grad()
    def fn(params, cache, tokens, pos):
        # a meta position has no value: decode at the last slot
        return step(params, cache, tokens, last)

    in_specs = (p_specs, c_specs, tok_spec, ())
    out_specs = (tok_spec, _logits_spec(cfg, shape, mesh), c_specs)
    return fn, (params_sh, cache_sh, tok_sh, pos_sh), in_specs, out_specs


def at_groups(cfg: ArchConfig, n_groups: int) -> ArchConfig:
    """``cfg`` cut to ``n_groups`` layer groups and its remainder blocks."""
    group, _, rem = cfg.scan_groups()
    out = dataclasses.replace(cfg, n_layers=n_groups * len(group) + len(rem))
    if out.scan_groups() != (group, n_groups, rem):
        raise AssertionError(f"{cfg.name}: {n_groups} groups factor as "
                             f"{out.scan_groups()}")
    return out


def _counted(cfg: ArchConfig, shape: ShapeConfig, mesh, cache, opt=False,
             dmesh=None):
    """(FLOPs, bytes, seconds, collective bytes) of one meta run of the
    cell's step: without ``dmesh`` global counts on plain tensors, with it
    rank 0's own on inputs placed over it."""
    fn, args, in_specs, _ = build_cell(cfg, shape, mesh, opt)
    t0 = time.perf_counter()
    if dmesh is None:
        with cache:
            flops, nbytes = jaxpr_cost.step_cost(fn, *args)
        coll = {"total": 0}
    else:
        args = tuple(sharding.place(a, s, dmesh)
                     for a, s in zip(args, in_specs))
        with cache:
            cost = jaxpr_cost.rank_cost(fn, *args)
        flops, nbytes, coll = cost["flops"], cost["bytes"], cost["collectives"]
    return flops, nbytes, time.perf_counter() - t0, coll


def count_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               opt: bool = False, dmesh=None) -> dict:
    """The cell's FLOPs, bytes and collective bytes (global on the host
    mesh, rank 0's over ``dmesh``): a full-depth trace where it is
    expected within :data:`TRACE_BUDGET_S`, else the linear
    extrapolation from one and two layer groups (``flops_method``)."""
    _, n_groups, _ = cfg.scan_groups()
    t0 = time.perf_counter()
    cache = jaxpr_cost.MetaShapeCache()
    method = "traced"
    if n_groups > 2:
        f1, b1, _, c1 = _counted(at_groups(cfg, 1), shape, mesh, cache, opt,
                                 dmesh)
        f2, b2, s2, c2 = _counted(at_groups(cfg, 2), shape, mesh, cache,
                                  opt, dmesh)
        # the two-group trace's time per group, fixed costs included: a
        # full trace takes at most this
        if s2 * n_groups / 2 > TRACE_BUDGET_S:
            method = "group_extrapolated"
            grow = lambda one, two: one + (n_groups - 1) * (two - one)
            flops, nbytes = grow(f1, f2), grow(b1, b2)
            coll = {k: grow(v, c2[k]) for k, v in c1.items()}
    if method == "traced":
        flops, nbytes, _, coll = _counted(cfg, shape, mesh, cache, opt,
                                          dmesh)
    return {"flops": flops, "hbm_bytes": nbytes, "collectives": coll,
            "flops_method": method, "trace_s": time.perf_counter() - t0}


def _card_bytes():
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def run_cell(arch: str, shape_name: str, mesh_kind: str = "host",
             out_dir: str = OUT_DIR, *, n_devices: int | None = None) -> dict:
    """Dry-run one cell on ``mesh_kind`` (``host`` or a production mesh,
    module docstring) and write its record as
    ``{mesh_kind}__<arch>__<shape>.json`` under ``out_dir``."""
    if mesh_kind != "host" and mesh_kind not in PRODUCTION_MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}")
    cfg = configs.get_arch(arch)
    shape = configs.get_shape(shape_name)
    ok, why = configs.cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "runnable": ok, "skip_reason": why}
    if not ok:
        return rec

    opt = mesh_kind.startswith("opt")
    if mesh_kind == "host":
        mesh = make_host_mesh(n_devices)
        count = count_step(cfg, shape, mesh)
        per_device = mesh.size                   # global counts
    else:
        mesh = make_production_mesh(multi_pod=mesh_kind.endswith("multi"))
        with fake_world(mesh):
            count = count_step(cfg, shape, mesh, opt=opt,
                               dmesh=device_mesh(mesh, "cpu"))
        per_device = 1                           # rank 0's own counts
    n_dev = mesh.size
    _, args, in_specs, _ = build_cell(cfg, shape, mesh, opt)
    inputs = analytic_input_bytes_per_device(args, in_specs, mesh)
    card = _card_bytes()
    flops = count["flops"] / per_device
    hbm = count["hbm_bytes"] / per_device
    coll = count["collectives"]
    mf = analysis.model_flops(cfg, shape, n_dev)
    roof = analysis.analyze({"flops": flops, "bytes accessed": hbm}, coll,
                            model_flops_per_device=mf,
                            jaxpr_flops_per_device=flops,
                            machine=analysis.current_machine())
    rec.update({
        "n_devices": n_dev,
        "trace_s": count["trace_s"],
        "memory": {
            "analytic_input_bytes_per_device": inputs,
            "card_bytes": card,
            "inputs_exceed_card": None if card is None else inputs > card,
            "temp_bytes": None,
            "temp_bytes_note": "no compiled program whose temporaries "
                               "could be read: the input bytes are a "
                               "lower bound on the peak",
        },
        "flops": roof.flops,
        "flops_method": count["flops_method"],
        "hbm_bytes": roof.hbm_bytes,
        "collectives": coll,
        "roofline": roof.as_dict(),
        "machine": analysis.current_machine().name,
    })
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{mesh_kind}__{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: inputs "
          f"{inputs / 1e9:.2f} GB/device, flops/dev {roof.flops:.4e} "
          f"({count['flops_method']}, {count['trace_s']:.1f} s), coll "
          f"{coll['total']:.3e} B, bottleneck {roof.bottleneck}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="host",
                    choices=("host",) + PRODUCTION_MESHES)
    ap.add_argument("--n-devices", type=int, default=None,
                    help="cards of the host mesh (default: the visible "
                         "CUDA cards; required without one)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    extra = ["--mesh", args.mesh] + (
        [] if args.n_devices is None else ["--n-devices",
                                           str(args.n_devices)])

    if args.all:
        failures = []
        for cfg, shape, ok, why in configs.all_cells():
            if not ok:
                # record the skip without spawning
                os.makedirs(args.out, exist_ok=True)
                p = os.path.join(args.out,
                                 f"{args.mesh}__{cfg.name}__{shape.name}.json")
                with open(p, "w") as f:
                    json.dump({"arch": cfg.name, "shape": shape.name,
                               "mesh": args.mesh, "runnable": False,
                               "skip_reason": why}, f)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cfg.name, "--shape", shape.name,
                   "--out", args.out, *extra]
            print(">>", " ".join(cmd), flush=True)
            if subprocess.run(cmd).returncode != 0:
                failures.append((cfg.name, shape.name))
        if failures:
            print("FAILED CELLS:", failures)
            sys.exit(1)
        print("ALL CELLS PASSED")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    run_cell(args.arch, args.shape, args.mesh, args.out,
             n_devices=args.n_devices)


if __name__ == "__main__":
    main()
