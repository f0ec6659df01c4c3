"""The dry run's memory analysis (``roofline/jaxpr_cost.py``
``MemoryCounterMode``, ``extrapolated_peak``; ``launch/dryrun.py``):
argument and output bytes against the reference's
``compiled.memory_analysis()`` for reduced cells of each kind, steps
whose peak is worked out by hand, the shape cache allocating what an
uncached run does, and the peak's extrapolation past the depth where
the peak moves."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from torch.utils.checkpoint import checkpoint

from repro import configs as r_configs
from repro.configs.base import ShapeConfig as RShapeConfig

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline import jaxpr_cost

from test_torch_dryrun import SMALL, _reference_dryrun

MiB = 1 << 20
#: XLA's output buffer of a jitted step is a tuple: besides the leaves'
#: bytes ``output_size_in_bytes`` counts its index table, one 8-byte
#: pointer a leaf
TUPLE_ENTRY_BYTES = 8


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["yi-9b", "zamba2-2.7b",
                                  "qwen3-moe-30b-a3b"])
def test_memory_matches_reference(arch, kind, record_property):
    """On a one-device mesh the port's argument bytes are the reference's
    ``argument_size_in_bytes`` exactly, and its output bytes its
    ``output_size_in_bytes`` but for XLA's tuple table and the decode
    step's next tokens (int64 in the port, ``torch.argmax``'s dtype;
    int32 in the reference).  The temporaries are recorded beside the
    reference's, not held to them: XLA fuses and reuses buffers, the port
    runs op by op."""
    ref = _reference_dryrun()
    r_cfg = r_configs.get_arch(arch).reduced()
    r_shape = RShapeConfig(SMALL[kind].name, SMALL[kind].seq_len,
                           SMALL[kind].global_batch, kind)
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    fn, arg_shapes, in_sh, out_sh, donate = ref.build_cell(r_cfg, r_shape,
                                                           jmesh)
    with jmesh:
        analysis = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(
            *arg_shapes).compile().memory_analysis()
    n_out = len(jax.tree.leaves(jax.eval_shape(fn, *arg_shapes)))

    cfg = configs.get_arch(arch).reduced()
    mesh = Mesh(("data", "model"), (1, 1))
    got = dryrun.count_step(cfg, SMALL[kind], mesh)["memory"]
    token_widening = (SMALL[kind].global_batch * (8 - 4)
                      if kind == "decode" else 0)
    assert got["argument_bytes"] == analysis.argument_size_in_bytes
    assert got["output_bytes"] == (analysis.output_size_in_bytes
                                   - TUPLE_ENTRY_BYTES * n_out
                                   + token_widening)
    # the state or cache updated in place where the reference donates it
    # (the port's optimizer step counter is a new scalar: 4 bytes fewer)
    assert 0 <= analysis.alias_size_in_bytes - got["alias_bytes"] <= 4
    assert got["peak_bytes"] == (got["argument_bytes"] + got["temp_bytes"]
                                 + got["output_bytes"] - got["alias_bytes"])
    record_property("temp_bytes", got["temp_bytes"])
    record_property("reference_temp_bytes", analysis.temp_size_in_bytes)


def _memory(fn, *args, cache=False):
    mode = jaxpr_cost.MemoryCounterMode(args)
    with (jaxpr_cost.MetaShapeCache() if cache else _nothing()), mode:
        out = fn(*args)
    return mode.result(out)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_matmul_chain_peaks():
    """Four 1024 x 1024 float32 tensors of 4 MiB.  Named intermediates
    live to the end of the function: the argument, y, z and the output
    are alive at once, 16 MiB.  Unnamed ones die after their use: the
    product in flight and its operand, 12 MiB."""
    x = _meta(1024, 1024)

    def named(x):
        y = x @ x
        z = y @ y
        return z @ z

    assert _memory(named, x) == {
        "argument_bytes": 4 * MiB, "output_bytes": 4 * MiB,
        "alias_bytes": 0, "temp_bytes": 8 * MiB, "peak_bytes": 16 * MiB}
    assert _memory(lambda x: ((x @ x) @ x) @ x, x)["peak_bytes"] == \
        12 * MiB


def test_views_and_in_place_updates_allocate_nothing():
    """A view of an argument returns the argument's storage (counted
    once, an alias); an in-place update returns the argument itself."""
    x = _meta(1024, 1024)
    view = _memory(lambda x: x[2:].t(), x)
    assert view == {"argument_bytes": 4 * MiB,
                    "output_bytes": 4 * MiB - 2 * 4096,
                    "alias_bytes": 4 * MiB - 2 * 4096, "temp_bytes": 0,
                    "peak_bytes": 4 * MiB}
    assert _memory(lambda x: x.mul_(2), x) == {
        "argument_bytes": 4 * MiB, "output_bytes": 4 * MiB,
        "alias_bytes": 4 * MiB, "temp_bytes": 0, "peak_bytes": 4 * MiB}
    # two views of one argument are one storage
    assert _memory(lambda a, b: a + b, x[:512], x[512:])[
        "argument_bytes"] == 4 * MiB


def test_checkpointed_block_with_its_backward():
    """``y = tanh(x @ w) @ w`` under a non-reentrant checkpoint, then the
    gradient of ``y.sum()`` in ``w``; 4 MiB a tensor.  The forward keeps
    only y (h and t die, the checkpoint saves no activation).  The
    backward recomputes h and t and stops there (``t @ w`` is not rerun:
    every saved tensor is back), drops h, then holds at ``tanh``'s
    backward the arguments (8), y (the caller's), the recomputed t, the
    gradients of t and of w's second use and the new gradient of h: 28
    MiB, with the 4-byte loss and its 4-byte seed."""
    x, w = _meta(1024, 1024), _meta(1024, 1024, grad=True)

    def step(x, w):
        with torch.enable_grad():
            y = checkpoint(lambda x: torch.tanh(x @ w) @ w, x,
                           use_reentrant=False)
            g, = torch.autograd.grad(y.sum(), [w])
        return g

    got = _memory(step, x, w)
    assert got["peak_bytes"] == 28 * MiB + 8
    assert got["temp_bytes"] == 28 * MiB + 8 - 8 * MiB - 4 * MiB
    # the counter runs above the shape cache: the same allocations
    assert _memory(step, x, w, cache=True) == got


def test_shape_cache_runs_aliasing_ops_as_they_are():
    """``_unsafe_view`` returns its input's storage though its schema
    does not say so: the cache must not answer it with a fresh tensor,
    or a cached run would count a copy that no run makes."""
    x = _meta(64, 64)

    def step(x):
        return [torch.ops.aten._unsafe_view(x * 2, (4096,))
                for _ in range(3)]

    assert _memory(step, x, cache=True) == _memory(step, x)
    assert _memory(step, x)["peak_bytes"] == 4 * 64 * 64 * 4


def test_extrapolated_peak_past_a_moving_peak():
    """falcon-mamba-7b's reduced train step: its peak grows by one step
    to three groups, the peak moves to another op at seven
    (``count_step`` at nine groups against the full trace; a line through
    the two- and three-group peaks misses it), and the extrapolation of
    every op to nine groups equals the full trace."""
    cfg = dryrun.at_groups(configs.get_arch("falcon-mamba-7b").reduced(), 9)
    shape, mesh = SMALL["train"], Mesh(("data", "model"), (1, 1))
    full = dryrun._counted(cfg, shape, mesh, jaxpr_cost.MetaShapeCache())
    two, three = (dryrun._counted(dryrun.at_groups(cfg, g), shape, mesh,
                                  jaxpr_cost.MetaShapeCache())
                  for g in (2, 3))
    line = (two[4]["peak_bytes"]
            + 7 * (three[4]["peak_bytes"] - two[4]["peak_bytes"]))
    assert line < full[4]["peak_bytes"]
    assert jaxpr_cost.extrapolated_peak(two[5], three[5], 9) == \
        full[4]["peak_bytes"]
