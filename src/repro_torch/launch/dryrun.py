"""One-card dry run (port of ``repro/launch/dryrun.py``).

For an (architecture x input-shape) cell on the host mesh (this host's
cards, ``launch/mesh.make_host_mesh``): the cell's step (train, prefill
or decode) is built over ``meta`` inputs (``launch/specs.py``) and run
once under the FLOP and byte counters (``roofline/jaxpr_cost.py``).
Nothing is allocated and nothing is compiled, so a full configuration
that does not fit the card is still described.  The record, JSON under
``build/dryrun/`` by default, holds the inputs' bytes per device beside
the card's memory, the counted FLOPs and bytes, and the roofline terms
on the machine profile (``h100-sxm`` on an H100).  Run one cell:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k

or every cell, each in a fresh process (on a host without a card, add
``--n-devices 1`` to describe a one-card host mesh):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

What differs from the reference:

* The production meshes (``--mesh single|multi|optsingle|optmulti``)
  raise: the reference compiles them over 512 host devices and reads
  collective bytes from the HLO, and the port has neither a compiler of
  a sharded program nor NCCL byte counts yet (ROADMAP.md Queue 1 item
  7).  On the host mesh the collective bytes are 0.
* There are no compiler temp bytes (``compiled.memory_analysis()``): the
  record's ``temp_bytes`` is null.  The analytic input bytes are a lower
  bound on the peak memory, not the peak.
* FLOPs count what runs, so every loop trip is traced.  Where a
  full-depth trace would take more than :data:`TRACE_BUDGET_S`, the step
  is counted at one and two layer groups (with the remainder blocks as
  they are) and extrapolated linearly to the full depth: every group of
  a config is the same computation, so this is exact
  (``flops_method``: ``"traced"`` or ``"group_extrapolated"``).
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
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
from repro_torch.roofline import analysis, jaxpr_cost
from repro_torch.serve import step as serve_step_mod
from repro_torch.train import step as train_step_mod

OUT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"))
#: Seconds a full-depth trace may be expected to take before the count is
#: extrapolated from one and two layer groups (the estimate runs up to a
#: third low; the extrapolation is exact).
TRACE_BUDGET_S = 5.0
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


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """``(fn, args, in_specs, out_specs)``: the cell's step, its ``meta``
    arguments and their spec trees.  The steps update their state or
    cache in place, where the reference donates it."""
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
    cache_sh, tok_sh, pos_sh = lspecs.decode_arg_specs(cfg, shape)
    c_specs = sharding.cache_specs(cache_sh, mesh)
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


def _counted(cfg: ArchConfig, shape: ShapeConfig, mesh, cache):
    """(FLOPs, bytes, seconds) of one meta run of the cell's step."""
    fn, args, _, _ = build_cell(cfg, shape, mesh)
    t0 = time.perf_counter()
    with cache:
        flops, nbytes = jaxpr_cost.step_cost(fn, *args)
    return flops, nbytes, time.perf_counter() - t0


def count_step(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """The cell's global FLOPs and bytes: a full-depth trace where it is
    expected within :data:`TRACE_BUDGET_S`, else the linear extrapolation
    from one and two layer groups (``flops_method``)."""
    _, n_groups, _ = cfg.scan_groups()
    t0 = time.perf_counter()
    cache = jaxpr_cost.MetaShapeCache()
    method = "traced"
    if n_groups > 2:
        f1, b1, _ = _counted(at_groups(cfg, 1), shape, mesh, cache)
        f2, b2, s2 = _counted(at_groups(cfg, 2), shape, mesh, cache)
        # the two-group trace's time per group, fixed costs included: a
        # full trace takes at most this
        if s2 * n_groups / 2 > TRACE_BUDGET_S:
            method = "group_extrapolated"
            flops = f1 + (n_groups - 1) * (f2 - f1)
            nbytes = b1 + (n_groups - 1) * (b2 - b1)
    if method == "traced":
        flops, nbytes, _ = _counted(cfg, shape, mesh, cache)
    return {"flops": flops, "hbm_bytes": nbytes, "flops_method": method,
            "trace_s": time.perf_counter() - t0}


def _card_bytes():
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def run_cell(arch: str, shape_name: str, mesh_kind: str = "host",
             out_dir: str = OUT_DIR, *, n_devices: int | None = None) -> dict:
    """Dry-run one cell on the host mesh and write its record as
    ``host__<arch>__<shape>.json`` under ``out_dir``."""
    if mesh_kind in PRODUCTION_MESHES:
        raise NotImplementedError(
            f"--mesh {mesh_kind}: the production meshes need a compiled "
            "sharded program and NCCL collective bytes, which come with "
            "ROADMAP.md Queue 1 item 7; the port dry-runs --mesh host")
    if mesh_kind != "host":
        raise ValueError(f"unknown mesh {mesh_kind!r}")
    cfg = configs.get_arch(arch)
    shape = configs.get_shape(shape_name)
    ok, why = configs.cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "runnable": ok, "skip_reason": why}
    if not ok:
        return rec

    mesh = make_host_mesh(n_devices)
    n_dev = mesh.size
    _, args, in_specs, _ = build_cell(cfg, shape, mesh)
    inputs = analytic_input_bytes_per_device(args, in_specs, mesh)
    card = _card_bytes()
    count = count_step(cfg, shape, mesh)
    flops = count["flops"] / n_dev
    hbm = count["hbm_bytes"] / n_dev
    coll = {"total": 0}
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
          f"({count['flops_method']}, {count['trace_s']:.1f} s), "
          f"bottleneck {roof.bottleneck}")
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
    if args.mesh != "host":
        run_cell(args.arch, args.shape, args.mesh, args.out)   # raises
    extra = [] if args.n_devices is None else ["--n-devices",
                                               str(args.n_devices)]

    if args.all:
        failures = []
        for cfg, shape, ok, why in configs.all_cells():
            if not ok:
                # record the skip without spawning
                os.makedirs(args.out, exist_ok=True)
                p = os.path.join(args.out,
                                 f"host__{cfg.name}__{shape.name}.json")
                with open(p, "w") as f:
                    json.dump({"arch": cfg.name, "shape": shape.name,
                               "mesh": "host", "runnable": False,
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
