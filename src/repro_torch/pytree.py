"""Minimal pytree helpers over nested dicts and dataclasses of tensors —
the parameter, cache and KV-slab trees keep the JAX reference's
nested-dict layout, and the model states (wear, cache, simulator) are
dataclasses as the reference's registered pytrees are."""
from __future__ import annotations

import dataclasses


def _is_node(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more trees of equal structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a tree in field (or insertion) order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if _is_node(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_paths(tree, path: tuple = ()) -> list:
    """``(path, leaf)`` pairs of a nested-dict tree in ``jax.tree.leaves``
    order: dict keys sorted at every level (not insertion order, as
    :func:`tree_leaves` gives).  Optimizer sums and checkpoint files
    follow this order, so they line up with the reference's."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_paths(tree[k], path + (k,))]
    return [(path, tree)]


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over nested dicts, keeping the
    first tree's key order."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)
