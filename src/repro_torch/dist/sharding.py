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
reference's ``PartitionSpec``.  The rules read only a mesh's
``axis_names`` and ``shape`` (``launch/mesh.py``'s :class:`Mesh`).
Every emitted spec passes through ``_guard``: an axis that does not
evenly divide its dim is dropped to ``None`` (replicated), which is what
lets the same rules serve a one-card host mesh and the 16x16 production
mesh.

The reference's ``to_named`` (specs to JAX ``NamedSharding``s) has no
counterpart: placing tensors over a ``torch.distributed`` ``DeviceMesh``
needs several processes and comes with ROADMAP.md Queue 1 item 7.
"""
from __future__ import annotations

from repro_torch.pytree import tree_map, tree_map_with_path

# Column-parallel (shard the output-feature dim, last axis) vs
# row-parallel (shard the reduction/vocab dim, second-to-last axis).
_COL_PARALLEL = {"wq", "wk", "wv", "w_up", "w_gate", "wx", "wz", "unembed"}
_ROW_PARALLEL = {"wo", "w_down", "embed"}


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the shape of a ``(shape, dtype)``
    leaf of ``transformer.param_shapes``."""
    return tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)


def dp_axes(mesh):
    """The data-parallel axis (or axes) of a mesh: ("pod", "data") on
    multi-pod meshes, "data" otherwise."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


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
