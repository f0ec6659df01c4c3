"""Name-based partition-spec rules for params / batches / decode caches
(port of ``repro/dist/sharding.py``).

One rule engine, three entry points:

* ``param_specs``  — tensor-parallel layout by leaf name: column-parallel
  projections shard their output dim on ``model``; row-parallel ones
  (``wo``, ``w_down``) and the vocab embedding shard the reduction/vocab
  dim; norms replicate.  Leaves stacked under the ``groups`` axis keep
  that leading axis unsharded.
* ``batch_specs``  — leading (batch) dim over the data axes.
* ``cache_specs``  — batch over data; KV heads over ``model`` by default,
  or the sequence dim over ``model`` with ``seq_shard=True``
  (sequence-sharded decode).

A spec is a plain tuple with one entry per dimension, each ``None``
(replicated), an axis name, or a tuple of axis names: the entries of the
reference's ``PartitionSpec``.  The rules read only a mesh's axis names
and ``shape`` (``launch/mesh.py``'s :class:`Mesh`, or a ``DeviceMesh``).
Every emitted spec passes through ``_guard``: an axis that does not
evenly divide its dim is dropped to ``None`` (replicated), which is what
lets the same rules serve a one-card host mesh and the 16x16 production
mesh.

The reference's ``to_named`` (specs to JAX ``NamedSharding``s) is
:func:`placements`, and its ``device_put`` of a tree onto them is
:func:`place`: one process runs per position of a ``torch.distributed``
``DeviceMesh`` (``launch/mesh.device_mesh``) and holds its own block of
each leaf as a ``DTensor``.  :func:`gather` is the reference's
``np.asarray`` of a global array.

Every split that a placed tensor gives up or takes moves its blocks by
the raw ``torch.distributed`` collectives (``all_gather_into_tensor``,
and ``all_reduce`` for a partial sum), which every backend runs on card
tensors, never by DTensor's functional all-gather, which a gloo group of
CUDA tensors does not survive on some versions (ROADMAP Queue 3 item
18), in the forward pass or the backward: :class:`_Gather` is that one
gather, differentiable (its backward takes each process's own slice of
the gradient, as DTensor's ``Replicate`` -> ``Shard`` does), and
:class:`_Cut` its mirror (a process's own slice, its backward the raw
gather of the gradient).  :func:`redistribute` (DTensor's
``redistribute`` with every undone split gathered by the one and every
new split cut by the other; DTensor's own is left the partial sums),
:func:`constrain`, :func:`replicate_dim`, :func:`full`,
:func:`gather_rows` and :func:`gather_columns` are built on them, and
:class:`_Placed` wraps blocks as placed tensors whose gradients move by
:func:`redistribute`.  :func:`zeros` makes a placed tensor from its
blocks alone (a decode cache), :func:`vocab_rows` looks up the rows of a
vocabulary-sharded table, and :func:`local_map` runs a function on each
process's blocks.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from repro_torch.pytree import tree_map, tree_map_with_path

# Column-parallel (shard the output-feature dim, last axis) vs
# row-parallel (shard the reduction/vocab dim, second-to-last axis).
_COL_PARALLEL = {"wq", "wk", "wv", "w_up", "w_gate", "wx", "wz", "unembed"}
_ROW_PARALLEL = {"wo", "w_down", "embed"}


def _axis_names(mesh) -> tuple:
    """The axis names of a :class:`~repro_torch.launch.mesh.Mesh` or of a
    ``DeviceMesh``: the rules read either."""
    return tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)


def _axis_sizes(mesh) -> dict:
    return dict(zip(_axis_names(mesh), mesh.shape))


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the shape of a ``(shape, dtype)``
    leaf of ``transformer.param_shapes``."""
    return tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)


def dp_axes(mesh):
    """The data-parallel axis (or axes) of a mesh: ("pod", "data") on
    multi-pod meshes, "data" otherwise."""
    return ("pod", "data") if "pod" in _axis_names(mesh) else "data"


def _guard(axes, shape, mesh) -> tuple:
    """Drop any mesh axis that does not evenly divide its dim.

    ``axes`` may be shorter than ``shape`` (missing entries replicate) and
    entries may be axis tuples.  Always returns a spec of ``len(shape)``
    entries.
    """
    sizes = _axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        ax = axes[i] if i < len(axes) else None
        if ax is None:
            out.append(None)
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        denom = 1
        for a in group:
            denom *= sizes.get(a, 1)
        out.append(ax if denom > 1 and dim % denom == 0 else None)
    return tuple(out)


def _leaf_keys(path) -> list[str]:
    return [str(k) for k in path]


def _param_rule(keys: list[str], ndim: int, two_d_mlp: bool):
    """Pre-guard axis assignment for one parameter leaf."""
    name = keys[-1]
    axes = [None] * ndim
    # Leading stacked axis (params["groups"][...]) stays unsharded.
    n_lead = 1 if "groups" in keys[:-1] else 0
    eff = ndim - n_lead
    if eff < 2:
        return axes        # norms / biases / scalars: replicate
    if name in _COL_PARALLEL:
        axes[-1] = "model"
        if two_d_mlp and name in ("w_up", "w_gate"):
            axes[-2] = "data"
    elif name in _ROW_PARALLEL:
        axes[-2] = "model"
        if two_d_mlp and name == "w_down":
            axes[-1] = "data"
    elif name == "router":
        pass               # tiny: replicate next to its experts
    else:
        # Unknown >=2-D weight: column-parallel default.
        axes[-1] = "model"
    return axes


def param_specs(shapes, mesh, two_d_mlp: bool = False):
    """Spec tree matching the structure of a params tree (tensors or
    ``(shape, dtype)`` leaves)."""
    def one(path, leaf):
        shape = _shape(leaf)
        axes = _param_rule(_leaf_keys(path), len(shape), two_d_mlp)
        return _guard(axes, shape, mesh)
    return tree_map_with_path(one, shapes)


def batch_specs(batch, mesh):
    """Batch dim over the data axes; everything else replicated."""
    dp = dp_axes(mesh)

    def one(leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        return _guard([dp], shape, mesh)
    return tree_map(one, batch)


def cache_specs(cache, mesh, seq_shard: bool = False):
    """Decode-cache specs: KV layout (B, S, H, D) per attention leaf (one
    leading stacked axis under "groups"), SSM state (B, ...) otherwise."""
    dp = dp_axes(mesh)

    def one(path, leaf):
        keys = _leaf_keys(path)
        shape = _shape(leaf)
        ndim = len(shape)
        n_lead = 1 if "groups" in keys[:-1] else 0
        axes = [None] * ndim
        if ndim > n_lead:
            axes[n_lead] = dp                      # batch dim
        if keys[-1] in ("k", "v") and ndim - n_lead >= 4:
            if seq_shard:
                axes[n_lead + 1] = "model"         # sequence dim
            else:
                axes[n_lead + 2] = "model"         # KV-head dim
        return _guard(axes, shape, mesh)
    return tree_map_with_path(one, cache)


def placements(spec: tuple, mesh_dim_names) -> list:
    """A spec as ``DTensor`` placements, one per mesh dimension: an axis
    name shards the spec's dimension on that mesh dimension, a tuple of
    axes shards it on each of theirs (in mesh order, so the block order
    is the reference's ``P(("pod", "data"))``); other mesh dimensions
    replicate."""
    names = tuple(mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        group = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"axes {group} of dim {dim} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def place_leaf(x: torch.Tensor, spec: tuple, device_mesh) -> DTensor:
    """The full tensor ``x`` (the same on every process) as a ``DTensor``
    placed by ``spec``: this process cuts its own block at its mesh
    coordinate, with no collective.  A block that is a part of ``x`` is a
    copy, so ``x`` can be freed; where the placement cuts nothing the
    block is ``x`` itself (no second copy of a replicated model)."""
    pl = placements(spec, device_mesh.mesh_dim_names)
    coord = device_mesh.get_coordinate()
    block = x
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            block = block.chunk(device_mesh.size(i), p.dim)[coord[i]]
    if block is not x:
        block = block.clone()
    return DTensor.from_local(block, device_mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def block_bounds(shape, pl, device_mesh) -> tuple[list, list]:
    """(offset, size) per dimension of this process's block of a tensor
    of ``shape`` placed by ``pl`` (mesh dimensions in order, each
    ``Shard`` splitting the block the earlier ones left, as ``place_leaf``
    cuts it).  Raises for a split that is not even."""
    off, size = [0] * len(shape), list(shape)
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = device_mesh.size(i)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly over {n} processes")
            size[p.dim] //= n
            off[p.dim] += coord[i] * size[p.dim]
    return off, size


def zeros(shape, dtype, spec: tuple, device_mesh, device) -> DTensor:
    """A zero tensor of global ``shape`` placed by ``spec``, made as this
    process's block alone (the full tensor never exists)."""
    pl = placements(spec, device_mesh.mesh_dim_names)
    _, size = block_bounds(shape, pl, device_mesh)
    block = torch.zeros(size, dtype=dtype, device=device)
    return DTensor.from_local(block, device_mesh, pl, run_check=False)


def place(tree, spec_tree, device_mesh):
    """A tree of full tensors placed leaf by leaf by ``spec_tree`` (the
    reference's ``device_put`` onto ``to_named(specs)``)."""
    return tree_map(lambda x, s: place_leaf(x, s, device_mesh), tree,
                    spec_tree)


def constrain(t, axes):
    """The reference's ``with_sharding_constraint``: a ``DTensor``
    redistributed to the placements of ``_guard(axes)`` over its own
    mesh; a plain tensor (one process, no mesh) as it is."""
    if not isinstance(t, DTensor):
        return t
    dm = t.device_mesh
    spec = _guard(axes, t.shape, dm)
    return redistribute(t, placements(spec, dm.mesh_dim_names))


def replicate_dim(t: DTensor, dim: int) -> DTensor:
    """``t`` with every mesh dimension that shards its dimension ``dim``
    made ``Replicate`` by the raw all-gather (:class:`_Gather`), the
    others kept."""
    dim = dim % t.dim()
    return _gathered(t, [i for i, p in enumerate(t.placements)
                         if p == Shard(dim)])


def local_rows(fn, *tensors):
    """``fn(*tensors)`` on each process's own batch rows.  Placed
    tensors are redistributed to the batch placements of the first
    (:func:`row_placements`), ``fn`` runs on the local blocks, and its
    outputs (batch leading) come back placed the same way, gradients
    flowing through (:func:`local_map`).  ``fn`` must treat the rows
    independently.  Plain tensors go straight to ``fn``."""
    first = tensors[0]
    if not isinstance(first, DTensor):
        return fn(*tensors)
    rows = row_placements(first)
    return local_map(lambda *t: tuple(fn(*t)), tensors,
                     [rows] * len(tensors), rows)


def row_placements(t: DTensor) -> list:
    """``t``'s batch placements: ``Shard(0)`` where it splits dim 0,
    ``Replicate`` on every other mesh dimension."""
    return [p if p == Shard(0) else Replicate() for p in t.placements]


def local_map(fn, tensors, in_pl, out_pl):
    """``fn`` on each process's blocks: ``tensors[i]`` (placed) is
    redistributed to the placements ``in_pl[i]`` and ``fn`` runs on the
    local blocks (plain tensors pass as they are); each output comes back
    placed by ``out_pl[j]`` (one list of placements: every output so).
    ``fn`` must compute each output block from
    the input blocks alone.  Gradients flow through: an input replicated
    over a mesh dimension on which an output differs from process to
    process (split or partial) takes a ``Partial`` gradient there, the
    sum of every process's part.  Without a placed tensor, ``fn`` runs on
    the tensors as they are."""
    placed = [t for t in tensors if isinstance(t, DTensor)]
    if not placed:
        return fn(*tensors)
    dm = placed[0].device_mesh
    every = bool(out_pl) and isinstance(out_pl[0], Placement)
    varies = [any(not isinstance(pl[i], Replicate)
                  for pl in ([out_pl] if every else out_pl))
              for i in range(dm.ndim)]

    def local(t, pl):
        if not isinstance(t, DTensor):
            return t
        grad = [Partial() if varies[i] and isinstance(p, Replicate) else p
                for i, p in enumerate(pl)]
        return redistribute(t, pl).to_local(grad_placements=grad)

    out = fn(*(local(t, pl) for t, pl in zip(tensors, in_pl)))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    pls = [out_pl] * len(outs) if every else out_pl
    wrapped = tuple(_Placed.apply(o, dm, tuple(pl), None, None)
                    for o, pl in zip(outs, pls))
    return wrapped[0] if single else wrapped


def vocab_rows(table: DTensor, ids) -> DTensor:
    """``table[ids]`` for a table placed over a mesh: each process looks
    the ids up in its own block of vocabulary rows (zeros for ids
    outside it) and the blocks are summed over the mesh dimensions that
    split the vocabulary (an all-reduce of a plain ``Partial``; DTensor's
    own masked partial loses its mask under rematerialisation on some
    versions).  ``ids`` is a plain tensor, the same on every process, or
    placed by its rows; the result is placed by the ids' rows and
    replicated otherwise."""
    dm = table.device_mesh
    ids_pl = (list(ids.placements) if isinstance(ids, DTensor)
              else [Replicate()] * dm.ndim)
    if any(isinstance(p, Shard) and p.dim != 0 for p in table.placements):
        table = redistribute(table, [p if p == Shard(0) else Replicate()
                                     for p in table.placements])
    off, size = block_bounds(table.shape, table.placements, dm)
    lo, n = off[0], size[0]
    # the rows' gradient: each process's block of the table gets its
    # own ids' part, summed over the mesh dimensions that split the ids
    block = table.to_local(grad_placements=[
        Partial() if ids_pl[i] == Shard(0) else p
        for i, p in enumerate(table.placements)])
    local = ids.to_local() if isinstance(ids, DTensor) else ids
    inside = (local >= lo) & (local < lo + n)
    rows = torch.nn.functional.embedding((local - lo).clamp(0, n - 1),
                                         block)
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    split = [p == Shard(0) for p in table.placements]
    partial = _Placed.apply(rows, dm, tuple(
        Partial() if split[i] else ids_pl[i] for i in range(dm.ndim)),
        None, None)
    return partial.redistribute(dm, [Replicate() if split[i] else ids_pl[i]
                                     for i in range(dm.ndim)])


_REDUCE = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _all_gather(local: torch.Tensor, dim: int, device_mesh,
                mesh_dim: int) -> torch.Tensor:
    """The blocks of ``local`` along ``dim`` from every process of mesh
    dimension ``mesh_dim``, in order, by the raw
    ``all_gather_into_tensor``."""
    rows = local.movedim(dim, 0).contiguous()
    out = rows.new_empty((device_mesh.size(mesh_dim) * rows.shape[0],)
                         + tuple(rows.shape[1:]))
    torch.distributed.all_gather_into_tensor(
        out, rows, group=device_mesh.get_group(mesh_dim))
    return out.movedim(0, dim)


class _Placed(torch.autograd.Function):
    """``local`` as a ``DTensor`` placed by ``pl`` over ``dm`` (of global
    ``shape`` and ``stride`` where given): ``DTensor.from_local``, whose
    backward brings the gradient to ``pl`` by :func:`redistribute`, raw
    collectives, with a ``Partial`` placement's gradient made
    ``Replicate`` (the gradient of each part of a sum is the whole
    sum's).  DTensor's own backward of ``from_local`` differs between
    versions (a partial gradient of a partial output is reduced on some,
    passed on as it is on others) and may take its functional
    all-gather."""

    @staticmethod
    def forward(ctx, local, dm, pl, shape, stride):
        ctx.set_materialize_grads(False)
        ctx.pl = pl
        return DTensor.from_local(local, dm, list(pl), run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor):
            grad = redistribute(grad, [Replicate() if p.is_partial() else p
                                       for p in ctx.pl]).to_local()
        return grad, None, None, None, None


class _Gather(torch.autograd.Function):
    """``local``, this process's block of a tensor placed by ``pl`` over
    ``dm``, with the mesh dimensions ``dims`` made ``Replicate`` by raw
    collectives over their groups: ``Partial`` blocks all-reduced first,
    then ``Shard`` blocks gathered with ``all_gather_into_tensor``, the
    last mesh dimension first.  Backward, as DTensor's: each process's
    own slice of the replicated gradient (its ``Replicate`` ->
    ``Shard``), passed unchanged through every partial sum (the gradient
    of a partial sum is replicated, :func:`_gathered`)."""

    @staticmethod
    def forward(ctx, local, dm, pl, dims):
        ctx.dm, ctx.pl, ctx.dims = dm, pl, dims
        dist = torch.distributed
        for i in dims:
            if pl[i].is_partial():
                op = _REDUCE.get(getattr(pl[i], "reduce_op", None))
                if op is None:
                    raise ValueError(f"cannot reduce a {pl[i]} placement")
                local = local.clone()
                dist.all_reduce(local, op=getattr(dist.ReduceOp, op),
                                group=dm.get_group(i))
        for i in reversed(dims):
            if isinstance(pl[i], Shard):
                local = _all_gather(local, pl[i].dim, dm, i)
        return local

    @staticmethod
    def backward(ctx, grad):
        coord = ctx.dm.get_coordinate()
        for i, p in enumerate(ctx.pl):
            if p.is_partial() and getattr(p, "reduce_op", None) != "sum":
                raise NotImplementedError(f"the gradient through a {p} "
                                          "reduction")
            if isinstance(p, Shard) and i in ctx.dims:
                grad = grad.chunk(ctx.dm.size(i), p.dim)[coord[i]]
        return grad, None, None, None


def _gathered(t: DTensor, dims) -> DTensor:
    """``t`` with the mesh dimensions ``dims`` made ``Replicate`` by
    :class:`_Gather` (even splits only), the others kept."""
    dm, pl = t.device_mesh, tuple(t.placements)
    dims = tuple(sorted(dims))
    if not dims:
        return t
    block_bounds(t.shape, pl, dm)                    # even splits only
    local = t.to_local(grad_placements=[
        Replicate() if p.is_partial() else p for p in pl])
    local = _Gather.apply(local, dm, pl, dims)
    return _Placed.apply(local, dm, tuple(Replicate() if i in dims else p
                                          for i, p in enumerate(pl)),
                         t.shape, t.stride())


class _Cut(torch.autograd.Function):
    """``local``, this process's block of a tensor placed over ``dm``,
    cut to its own slice at each ``(mesh dimension, tensor dimension)``
    of ``cuts`` (the mesh dimensions ``Replicate`` before, in mesh order,
    each splitting the block the earlier left, as ``place_leaf`` cuts);
    no collective.  Backward, the mirror of :class:`_Gather`: the
    gradient's slices gathered by the raw all-gather, the last mesh
    dimension first (DTensor's ``Shard`` -> ``Replicate`` would take the
    functional one)."""

    @staticmethod
    def forward(ctx, local, dm, cuts):
        ctx.dm, ctx.cuts = dm, cuts
        coord = dm.get_coordinate()
        for i, d in cuts:
            local = local.chunk(dm.size(i), d)[coord[i]]
        return local.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        for i, d in reversed(ctx.cuts):
            grad = _all_gather(grad, d, ctx.dm, i)
        return grad, None, None


def _cut(t: DTensor, pl) -> DTensor:
    """``t`` with each mesh dimension that is ``Replicate`` in ``t`` and
    ``Shard`` in ``pl`` split by :class:`_Cut` (even splits only); every
    other placement of ``pl`` must be ``t``'s already."""
    dm, src = t.device_mesh, list(t.placements)
    cuts = []
    for i, (p, q) in enumerate(zip(src, pl)):
        if p == q:
            continue
        if not (isinstance(p, Replicate) and isinstance(q, Shard)):
            raise ValueError(f"cannot cut {p} to {q} on mesh dimension {i}")
        cuts.append((i, q.dim))
    if not cuts:
        return t
    block_bounds(t.shape, pl, dm)                    # even splits only
    local = t.to_local(grad_placements=[
        Replicate() if p.is_partial() else p for p in src])
    return _Placed.apply(_Cut.apply(local, dm, tuple(cuts)), dm, tuple(pl),
                         t.shape, t.stride())


def _undone(src, pl) -> list:
    """The mesh dimensions of ``src`` to gather before moving to ``pl``:
    each that splits a tensor dimension whose splits in ``pl`` do not
    begin with ``src``'s (a split given up, moved to another dimension,
    or with a new split put outside it)."""
    out = []
    for d in sorted({p.dim for p in src if isinstance(p, Shard)}):
        have = [i for i, p in enumerate(src) if p == Shard(d)]
        want = [i for i, q in enumerate(pl) if q == Shard(d)]
        if want[:len(have)] != have:
            out += have
    return out


def redistribute(t: DTensor, pl) -> DTensor:
    """``t.redistribute(t.device_mesh, pl)`` by raw collectives: every
    split that ``pl`` gives up or moves (``Shard(a)`` -> ``Shard(b)``
    too) is made whole first by :class:`_Gather`, DTensor then reduces
    the partial sums (an all-reduce, or a reduce-scatter outside
    autograd: its backward would gather, so a tensor that takes a
    gradient is all-reduced and cut), and :class:`_Cut` makes every new
    split.  DTensor's own redistribution is never asked for an
    all-gather, in either pass."""
    src, pl = list(t.placements), list(pl)
    if src == pl:
        return t
    t = _gathered(t, _undone(src, pl))
    mid = []
    for p, q in zip(t.placements, pl):
        if p.is_partial() and isinstance(q, Shard) and t.requires_grad:
            mid.append(Replicate())
        elif p.is_partial() or (isinstance(p, Replicate) and
                                q.is_partial()):
            mid.append(q)
        else:
            mid.append(p)
    if mid != list(t.placements):
        t = t.redistribute(t.device_mesh, mid)
    return _cut(t, pl)


def full(x):
    """A ``DTensor`` as its full tensor, this process's plain tensor
    (every process calls it), by :class:`_Gather` over every mesh
    dimension that splits it or holds a partial sum; any other value as
    it is."""
    if not isinstance(x, DTensor):
        return x
    return _gathered(x, [i for i, p in enumerate(x.placements)
                         if not isinstance(p, Replicate)]).to_local()


def gather_rows(x):
    """A placed KV leaf's batch rows (the dimension fourth from the end)
    gathered over the mesh dimensions that split them
    (:class:`_Gather`); those mesh dimensions become ``Replicate`` and
    the others keep their blocks.  A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = x.dim() - 4
    return _gathered(x, [i for i, p in enumerate(x.placements)
                         if p == Shard(dim)])


def gather_columns(parts, device_mesh, mesh_dims) -> list:
    """``parts``, this process's blocks of tensors whose last dimension
    is split evenly over ``mesh_dims`` (their other dimensions alike,
    one dtype), each made whole by one raw all-gather of them all
    (:func:`_all_gather`, the last mesh dimension first, as
    :class:`_Gather`).  Not differentiable: a decode step's
    activations."""
    if not mesh_dims:
        return list(parts)
    widths = [p.shape[-1] for p in parts]
    buf = torch.cat(list(parts), dim=-1)[None]
    for i in reversed(mesh_dims):
        buf = _all_gather(buf, 0, device_mesh, i)
    out, lo = [], 0
    for w in widths:
        block = buf[..., lo:lo + w]                  # (M, ..., w)
        out.append(block.movedim(0, -2).reshape(block.shape[1:-1] + (-1,)))
        lo += w
    return out


def gather(tree):
    """Every ``DTensor`` leaf as its full tensor (:func:`full`; every
    process calls it), other leaves as they are."""
    return tree_map(full, tree)
