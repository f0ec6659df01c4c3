"""FLOPs, bytes and memory of one eager step (port of
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

The dry run counts a step in one dispatch, :class:`RankCostMode`: the
FLOPs by ``FlopCounterMode``'s formulas, the bytes, the collectives and
the memory below.  A step placed over a mesh (``DTensor`` inputs) is
counted as one process runs it: the ops on its own blocks, and the
collectives it issues.

:class:`MemoryCounterMode` is the counterpart of XLA's
``compiled.memory_analysis()``: the bytes of the storages alive while
the step runs, from its arguments to its peak.  It counts what the
dispatcher sees allocated, which on the card is what the caching
allocator hands out for tensors, but for these, which no ``meta`` op
shows (held to the H100 by ``chip_smoke.py`` phase 9 (b), where the
count run on the card's own tensors equals the ``meta`` count to the
byte at four steps):

* the caching allocator hands out more than a tensor asks for (blocks
  rounded up to 512 B, a large request given a whole cached block):
  its ``allocated_bytes`` over its ``requested_bytes``, 15.9 MB of
  zamba2-2.7b's 18.4 GB train step peak (2 x 512), 0 at yi-9b's
  prefill and decode (2 x 96);
* workspaces a CUDA op allocates inside itself: cuBLAS's (per thread
  and stream, allocated by the first GEMM and kept, so they belong to
  the state a step starts from once any GEMM has run) and CUB's
  temporaries of ``sort``, ``topk``, ``cumsum`` and accumulating
  ``index_put_`` (MoE routing), freed before the op returns.  At
  qwen3-moe-30b-a3b's prefill peak (2 x 96) the allocator held 256 KiB
  over the count, this or the rounding (not parted).

A non-reentrant checkpoint's recompute is counted where it runs and as
far as it runs (it stops once the backward has every tensor it saved),
and what autograd saves is counted while it lives.  The steps update
their state or cache in place where the reference donates it: those
outputs are the arguments' own storages (``alias_bytes``).

The reference's jaxpr walker (``jaxpr_flops`` and its per-primitive
rules) has no counterpart: there is no jaxpr to walk.
"""
from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.roofline.analysis import CollectiveCounter

_aten = torch.ops.aten
#: The profiler range a model runs each layer group under,
#: ``f"{GROUP_RANGE} {g}"`` (``models/transformer._run_stack``; a
#: checkpoint's recompute enters it again): :class:`MemoryCounterMode`
#: labels every op with the group entered last.
GROUP_RANGE = "layer group"
_ENTER_RANGE = torch.ops.profiler._record_function_enter_new.default
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


def _local_leaves(tree):
    """The tensors of ``tree``: a placed tensor's own block in its place,
    the fake tensors DTensor propagates shapes with left out."""
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
            yield t


class MemoryCounterMode(TorchDispatchMode):
    """Live storage bytes of one step run under it, on the device of its
    tensor arguments ``args`` (placed arguments: their local blocks).

    Every storage an op returns is counted once, whatever views it has,
    from the op that allocates it until its last reference dies (a weak
    reference's callback on the untyped storage), so what autograd saves
    and what a checkpoint recomputes count while they live.  Ops on
    placed tensors are left to DTensor and the fake-tensor ops it
    propagates shapes with are not counted, as :class:`RankCostMode`
    does.  Enter it above :class:`MetaShapeCache`, whose fresh meta
    tensors stand for the allocations of an uncached run.
    :meth:`result` gives XLA's split of the step's footprint."""

    def __init__(self, args=()):
        super().__init__()
        leaves = list(_local_leaves(args))
        self.device = leaves[0].device if leaves else None
        self._refs = {}         # id(storage) -> weak reference
        self._sizes = {}        # weak reference -> [id(storage), nbytes]
        self.live = self.peak = 0
        self.argument_bytes = self._track(leaves)
        self._args = set(self._refs.values())
        #: (phase, layer group, op, live bytes) after every op: the phase
        #: counts the switches between the forward and autograd's
        #: backward, the group is the last :data:`GROUP_RANGE` entered in
        #: the phase (None before the first)
        self.timeline = []
        self._phase, self._backward, self._group = 0, False, None

    def _track(self, tensors) -> int:
        """Count the storages of ``tensors`` not counted yet (and a
        counted one's new size, if an op resized it); the bytes added."""
        added = 0
        for t in tensors:
            if t.device != self.device:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            ref = self._refs.get(id(st))
            if ref is None or ref() is not st:
                ref = weakref.ref(st, self._free)
                self._refs[id(st)] = ref
                self._sizes[ref] = [id(st), 0]
            added += n - self._sizes[ref][1]
            self._sizes[ref][1] = n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, ref) -> None:
        key, n = self._sizes.pop(ref)
        if self._refs.get(key) is ref:
            del self._refs[key]
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        backward = torch._C._current_graph_task_id() != -1
        if backward != self._backward:
            self._phase += 1
            self._backward, self._group = backward, None
        if func is _ENTER_RANGE and args[0].startswith(GROUP_RANGE):
            self._group = int(args[0][len(GROUP_RANGE):])
        if self.device is not None and not func.is_view:
            self._track((out,) if type(out) is torch.Tensor
                        else _local_leaves(out))
        self.timeline.append((self._phase, self._group, func, self.live))
        return out

    def result(self, out) -> dict:
        """The step's ``argument_bytes`` (each argument storage once),
        ``output_bytes`` (every returned tensor, as XLA's
        ``output_size_in_bytes``), ``alias_bytes`` (the outputs that are
        arguments updated in place), ``peak_bytes`` (the most bytes alive
        at once, arguments included) and ``temp_bytes``, the peak less
        the arguments and the outputs that are not arguments (at least
        0), so that arguments + outputs + temporaries bound the step."""
        sizes = [(t.numel() * t.element_size(),
                  self._refs.get(id(t.untyped_storage())) in self._args)
                 for t in _local_leaves(out)]
        output = sum(n for n, _ in sizes)
        alias = sum(n for n, arg in sizes if arg)
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": output, "alias_bytes": alias,
                "temp_bytes": max(0, self.peak - self.argument_bytes
                                  - (output - alias)),
                "peak_bytes": self.peak}


def _families(timeline: list, n_groups: int) -> dict:
    """``timeline``'s (op, live bytes) by phase and by place: before the
    layer groups, in the first, a middle or the last group (and after
    it)."""
    out = {}
    for phase, g, func, live in timeline:
        place = ("before" if g is None else "first" if g == 0 else
                 "last" if g == n_groups - 1 else "middle")
        out.setdefault((phase, place), []).append((func, live))
    return out


def _common_ops(a: list, b: list, limit: int = 4096) -> list:
    """The (i, j) pairs of ops ``a[i] is b[j]`` that a shortest edit
    script from ``a`` to ``b`` keeps: their common prefix and suffix, and
    between them Myers' O((N + M) D) difference, fast where two groups
    differ by a few ops.  ValueError past ``limit`` edits."""
    pre = 0
    while pre < min(len(a), len(b)) and a[pre] is b[pre]:
        pre += 1
    suf = 0
    while suf < min(len(a), len(b)) - pre and a[-1 - suf] is b[-1 - suf]:
        suf += 1
    a_in, b_in = a[pre:len(a) - suf], b[pre:len(b) - suf]
    v, trace = {1: 0}, []
    for d in range(limit + 1 if a_in and b_in else 0):
        trace.append(dict(v))
        for k in range(-d, d + 1, 2):
            if k == -d or (k != d and v[k - 1] < v[k + 1]):
                x = v[k + 1]
            else:
                x = v[k - 1] + 1
            y = x - k
            while x < len(a_in) and y < len(b_in) and a_in[x] is b_in[y]:
                x, y = x + 1, y + 1
            v[k] = x
            if x >= len(a_in) and y >= len(b_in):
                break
        else:
            continue
        break
    else:
        if a_in and b_in:
            raise ValueError(f"the groups' ops differ by over {limit} "
                             f"edits")
    inner, x, y = [], len(a_in), len(b_in)
    for d in range(len(trace) - 1, -1, -1):
        v, k = trace[d], x - y
        if k == -d or (k != d and v[k - 1] < v[k + 1]):
            prev = k + 1
        else:
            prev = k - 1
        px = v[prev] if d else 0
        py = px - prev if d else 0
        while x > px and y > py:
            x, y = x - 1, y - 1
            inner.append((pre + x, pre + y))
        x, y = px, py
    return ([(i, i) for i in range(pre)] + inner[::-1]
            + [(len(a) - suf + i, len(b) - suf + i) for i in range(suf)])


def extrapolated_peak(two: list, three: list, n_groups: int) -> int:
    """The peak live bytes of a step at ``n_groups`` layer groups from
    its :attr:`MemoryCounterMode.timeline` at two and at three groups.

    The live bytes after an op are affine in the group count for the op
    at the same place: before the first group, in the first group, or in
    the last group and after it.  The first and the last group differ
    from the groups between them (the stack's input is alive in the
    first, and the first contribution to a gradient is kept, not added),
    so each place is extrapolated from its own ops in the two traces.  A
    middle group, which only the three-group trace has, grows with the
    count as the first group does at the same op and with its position
    as the last group does, so the middle groups peak in the second or
    the second-to-last group.  Ops are matched by a shortest edit script
    between their sequences (:func:`_common_ops`): a middle group's to the
    first's and the last's, which may run a few ops more or fewer (the
    first group's backward is followed by the embedding's, the last
    group's adds no gradient to an earlier contribution), and each place's
    in the two traces, where an op only the first trace runs (DTensor's
    first sight of an op places an empty tensor) is left out: a warm step
    does not run it.  Raises where the traces' phases differ or a middle
    group's op matches neither end group's."""
    at2, at3 = _families(two, 2), _families(three, 3)
    if set(at2) != {k for k in at3 if k[1] != "middle"}:
        raise ValueError(f"the traces' phases and places differ: "
                         f"{sorted(at2)} and {sorted(at3)}")
    peak, slope = 0, {}
    for key, ops in at2.items():
        slope[key] = [None] * len(at3[key])
        for i, j in _common_ops([f for f, _ in ops],
                                [f for f, _ in at3[key]]):
            slope[key][j] = at3[key][j][1] - ops[i][1]
            peak = max(peak, ops[i][1] + (n_groups - 2) * slope[key][j])
    for (phase, place), ops in at3.items():
        if place != "middle":
            continue
        grows = [[] for _ in ops]
        for end in ("first", "last"):
            for i, j in _common_ops([f for f, _ in ops],
                                    [f for f, _ in at3[phase, end]]):
                if slope[phase, end][j] is not None:
                    grows[i].append(slope[phase, end][j])
        for k, ((func, live), grow) in enumerate(zip(ops, grows)):
            if not grow:
                raise ValueError(f"phase {phase}: a middle group's op {k} "
                                 f"({func}) is neither the first's nor the "
                                 f"last's")
            peak = max(peak, live + (n_groups - 3) * max(grow))
    return peak


class RankCostMode(MemoryCounterMode):
    """What one process computes in a step, placed over a mesh or not, in
    one dispatch: the FLOPs (``torch.utils.flop_counter``'s formulas, as
    ``FlopCounterMode`` counts them) and bytes (:func:`_op_bytes`) of the
    ops on its own blocks, the collectives it issues (``collectives``, a
    :class:`~repro_torch.roofline.analysis.CollectiveCounter`, whose
    bytes are not counted as memory traffic) and the live bytes of
    :class:`MemoryCounterMode`.  Ops on placed tensors are left to
    DTensor, which runs them as ops on the blocks; the ops DTensor runs on
    fake tensors to propagate shapes compute nothing and are not
    counted."""

    def __init__(self, args=()):
        super().__init__(args)
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveCounter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        if func.namespace in ("_c10d_functional", "c10d"):
            self.collectives.record(func, out)
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
    ops with a tensor argument off the meta device, any op whose
    outputs are not all meta tensors (a factory on the CPU) and any op
    whose output shares an argument's storage though its schema does not
    say so (``_unsafe_view``) run as they are, so a cached run allocates
    what an uncached run does.  Enter it before the counters, so that
    they see every op and it answers below them."""

    def __init__(self):
        super().__init__()
        self._outputs = {}
        self._aliasing = set()

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
        if key in self._aliasing:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        leaves, spec = tree_flatten(out)
        if all(isinstance(t, torch.Tensor) and t.is_meta for t in leaves):
            given = {id(t.untyped_storage()) for t in tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)}
            if any(id(t.untyped_storage()) in given for t in leaves):
                self._aliasing.add(key)
            else:
                self._outputs[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                                       for t in leaves], spec)
        return out


def step_cost(fn, *args) -> tuple[float, float]:
    """(FLOPs, bytes) of ``fn(*args)``, run once under both counters."""
    with FlopCounterMode(display=False) as flops, ByteCounterMode() as nbytes:
        fn(*args)
    return float(flops.get_total_flops()), float(nbytes.total)


def rank_cost(fn, *args) -> dict:
    """One process's FLOPs, bytes, collective bytes by kind, memory
    (:meth:`MemoryCounterMode.result`) and memory timeline of
    ``fn(*args)``, run once under :class:`RankCostMode`."""
    with RankCostMode(args) as mode:
        out = fn(*args)
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "collectives": mode.collectives.as_dict(),
            "memory": mode.result(out), "timeline": mode.timeline}


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
