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
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

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
    coordinate, with no collective; the block is a copy, so ``x`` can be
    freed."""
    pl = placements(spec, device_mesh.mesh_dim_names)
    coord = device_mesh.get_coordinate()
    block = x
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            block = block.chunk(device_mesh.size(i), p.dim)[coord[i]]
    return DTensor.from_local(block.clone(), device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


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
    return t.redistribute(dm, placements(spec, dm.mesh_dim_names))


def replicate_dim(t: DTensor, dim: int) -> DTensor:
    """``t`` with every mesh dimension that shards its dimension ``dim``
    redistributed to ``Replicate`` (an all-gather), the others kept."""
    dim = dim % t.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def local_rows(fn, *tensors):
    """``fn(*tensors)`` on each process's own batch rows.  Placed
    tensors are redistributed to the batch placements of the first
    (``Shard(0)`` where it shards dim 0, ``Replicate`` on every other mesh
    dimension), ``fn`` runs on the local blocks, and its outputs (batch
    leading) come back placed the same way, gradients flowing through.
    ``fn`` must treat the rows independently.  Plain tensors go straight
    to ``fn``."""
    first = tensors[0]
    if not isinstance(first, DTensor):
        return fn(*tensors)
    dm = first.device_mesh
    rows = [p if p == Shard(0) else Replicate() for p in first.placements]
    out = fn(*(t.redistribute(dm, rows).to_local() for t in tensors))
    return tuple(DTensor.from_local(o, dm, rows, run_check=False)
                 for o in out)


def gather(tree):
    """Every ``DTensor`` leaf as its full tensor (a collective: every
    process calls it), other leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)
