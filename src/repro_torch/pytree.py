"""Minimal pytree helpers over nested dicts of tensors — the parameter,
cache and KV-slab trees keep the JAX reference's nested-dict layout."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more dict trees of equal shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a dict tree in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
