"""FLOPs and bytes of one eager step (port of
``repro/roofline/jaxpr_cost.py``; the file keeps the reference's name so a
reader finds the counterpart).

The reference walks the jaxpr, because XLA's cost analysis counts a
scan's body once and its models scan over layer groups, KV chunks and
loss chunks.  The port runs eagerly, so it counts what runs:
:func:`step_flops` calls the step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts matmuls,
batched matmuls and convolutions (2 x M x N x K, as the reference's
``dot_general`` rule does).

* Every loop trip runs, so no trip-count correction is needed.
* Each ``torch.utils.checkpoint`` recompute counts where it runs, in the
  backward pass, as the reference counts a remat body at every call
  site.  A non-reentrant checkpoint stops recomputing once the backward
  has every tensor it saved, so a body's last ops may not rerun: what is
  counted is what ran.
* The step may run on ``meta`` tensors (``launch/specs.py``): the counts
  depend only on shapes, so they equal the counts of the same step on
  the card or the CPU, and nothing is allocated.

:func:`step_bytes` is the counterpart of XLA's ``"bytes accessed"``: the
bytes of every aten op's tensor operands and outputs, views and metadata
ops skipped.  It is an unfused count (each op's intermediates go to
memory and back), so it is higher than XLA's count of a fused program.

:class:`MetaShapeCache` makes a meta run fast enough to count a full
configuration: the meta device computes each op's output shape in
Python (tens of microseconds an op), and a step repeats the same few
ops thousands of times (a scan's per-token update, a chunk loop).

A step placed over a mesh (``DTensor`` inputs) is counted by
:class:`RankCostMode` as one process runs it: the FLOPs and bytes of the
ops on its own blocks, and the collectives it issues.

The reference's jaxpr walker (``jaxpr_flops`` and its per-primitive
rules) has no counterpart: there is no jaxpr to walk.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.roofline.analysis import CollectiveCounter

_aten = torch.ops.aten
# Ops that touch no element: allocation and metadata.
_NO_DATA = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.detach.default,
            _aten.lift_fresh.default, _aten._unsafe_view.default,
            _aten.alias.default, _aten.is_same_size.default}


def _op_bytes(func, args, kwargs, out) -> int:
    """The bytes of an op's tensor arguments and outputs (``numel x
    element size``; an in-place op's operand is read and written, so it
    counts twice); 0 for views and :data:`_NO_DATA` ops."""
    if func.is_view or func in _NO_DATA:
        return 0
    return sum(t.numel() * t.element_size()
               for t in tree_leaves((args, kwargs, out))
               if isinstance(t, torch.Tensor))


class ByteCounterMode(TorchDispatchMode):
    """Sums :func:`_op_bytes` over every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += _op_bytes(func, args, kwargs, out)
        return out


class RankCostMode(CollectiveCounter):
    """What one process of a mesh computes in a step placed over it: the
    FLOPs (``torch.utils.flop_counter``'s formulas) and bytes
    (:func:`_op_bytes`) of the ops on its own blocks, and the collectives
    it issues (:class:`~repro_torch.roofline.analysis.CollectiveCounter`,
    whose bytes are not counted as memory traffic).  Ops on placed
    tensors are left to DTensor, which runs them as ops on the blocks;
    the ops DTensor runs on fake tensors to propagate shapes compute
    nothing and are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        if func.namespace in ("_c10d_functional", "c10d"):
            self.record(func, out)
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes += _op_bytes(func, args, kwargs, out)
        return out


def _meta_key(x):
    """A hashable key of an op argument's metadata; TypeError for an
    argument the cache does not key on (a tensor with values, a
    generator, a symbolic size)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError(x.device)
        return (x.dtype, tuple(x.shape), x.stride())
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_meta_key(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _meta_key(v)) for k, v in x.items()))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(x), x)
    raise TypeError(type(x))


class MetaShapeCache(TorchDispatchMode):
    """Memoises the output shapes, strides and dtypes of functional aten
    ops on ``meta`` tensors, keyed on the op and its arguments' metadata
    (a meta kernel reads nothing else), and answers a repeated op with
    fresh meta tensors of those shapes.  Views, in-place and aliasing ops,
    ops with a tensor argument off the meta device, and any op whose
    outputs are not all meta tensors (a factory on the CPU) run as they
    are.  Enter it before the counters,
    so that they see every op and it answers below them."""

    def __init__(self):
        super().__init__()
        self._outputs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on its blocks
        kwargs = kwargs or {}
        schema = func._schema
        if func.is_view or schema.is_mutable or any(
                r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        hit = self._outputs.get(key)
        if hit is not None:
            metas, spec = hit
            return tree_unflatten(
                [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                 for shape, stride, dtype in metas], spec)
        out = func(*args, **kwargs)
        leaves, spec = tree_flatten(out)
        if all(isinstance(t, torch.Tensor) and t.is_meta for t in leaves):
            self._outputs[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                                   for t in leaves], spec)
        return out


def step_cost(fn, *args) -> tuple[float, float]:
    """(FLOPs, bytes) of ``fn(*args)``, run once under both counters."""
    with FlopCounterMode(display=False) as flops, ByteCounterMode() as nbytes:
        fn(*args)
    return float(flops.get_total_flops()), float(nbytes.total)


def rank_cost(fn, *args) -> dict:
    """One process's (FLOPs, bytes, collective bytes by kind) of
    ``fn(*args)`` on placed inputs, run once under
    :class:`RankCostMode`."""
    with RankCostMode() as mode:
        fn(*args)
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "collectives": mode.as_dict()}


def step_flops(fn, *args) -> float:
    """Global FLOPs of ``fn(*args)``, run once."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def step_bytes(fn, *args) -> float:
    """Bytes the aten ops of ``fn(*args)`` read and write, run once
    (:class:`ByteCounterMode`)."""
    with ByteCounterMode() as counter:
        fn(*args)
    return float(counter.total)
