"""Atomic-publish checkpoints: write to ``step_N.tmp``, fsync, rename —
port of ``repro/dist/checkpoint.py``, in the same on-disk format, so a
checkpoint written by either package restores in the other.

A checkpoint directory holds ``step_<N>/`` dirs; each contains one
``leaf_<i>.npy`` per tree leaf plus ``manifest.json``.  Leaves are
numbered in ``jax.tree.leaves`` order — dict keys sorted at every level
(``pytree.tree_paths``) — not in the tree's insertion order.  A step dir
WITHOUT a manifest is an unfinished writer crash and is ignored by
readers and eventually garbage-collected by writers: the rename is the
publish.

A state placed over a mesh (``DTensor`` leaves, ``dist/sharding.place``)
is saved by every process: each leaf is gathered whole on every process
in turn (``sharding.full``, raw collectives), process 0 writes it, and the
files are the same topology-free files.  ``restore`` returns full
tensors, which the caller places again over whatever mesh it has.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist import sharding
from repro_torch.pytree import tree_map_with_path, tree_paths

MANIFEST = "manifest.json"
_PREFIX = "step_"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_PREFIX}{step}")


def published_steps(root: str) -> list[int]:
    """Sorted steps with a complete (manifest-bearing) checkpoint."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if not name.startswith(_PREFIX) or name.endswith(".tmp"):
            continue
        try:
            step = int(name[len(_PREFIX):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(root, name, MANIFEST)):
            steps.append(step)
    return sorted(steps)


def _gc(root: str, keep_last: int | None) -> None:
    """Remove crashed-writer droppings and over-retention checkpoints."""
    for name in os.listdir(root):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    if keep_last is not None:
        for step in published_steps(root)[:-keep_last]:
            shutil.rmtree(_step_dir(root, step), ignore_errors=True)


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """numpy has no bfloat16: a bf16 leaf is written as its raw 2-byte
    bits, a ``V2`` array, which is how the reference's files hold one."""
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A loaded leaf as a tensor: 2-byte raw bits (``V2``, either
    package's bf16 leaf) are read back as bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(root: str, step: int, state, keep_last: int | None = None,
         process_index: int | None = None) -> str:
    """Publish ``state`` (a dict tree of tensors or arrays) at ``step``;
    returns the published directory.

    Only process 0 writes (``process_index`` defaults to the
    ``torch.distributed`` rank when a group is initialised, else 0); other
    processes return the would-be path without touching disk.  A placed
    state must be saved by every process of its mesh: each joins every
    leaf's gather, and all return once process 0 has published."""
    if process_index is None:
        process_index = _rank()
    final = _step_dir(root, step)
    leaves = [leaf for _, leaf in tree_paths(state)]
    placed = any(isinstance(leaf, DTensor) for leaf in leaves)
    if process_index != 0:
        for leaf in leaves:                  # join process 0's gathers
            if isinstance(leaf, DTensor):
                sharding.full(leaf)
        if placed:
            torch.distributed.barrier()
        return final
    os.makedirs(root, exist_ok=True)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, DTensor):
            leaf = sharding.full(leaf)
        if torch.is_tensor(leaf):
            leaf = _to_numpy(leaf.detach().cpu())
        with open(os.path.join(tmp, f"leaf_{i}.npy"), "wb") as f:
            np.save(f, np.asarray(leaf))
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves)}, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)        # the atomic publish
    # Make the rename itself durable before gc deletes older steps —
    # otherwise a crash can surface the new dir with stale data blocks
    # while the previous complete checkpoint is already gone.
    dirfd = os.open(root, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    _gc(root, keep_last)
    if placed:
        torch.distributed.barrier()
    return final


def restore(root: str, step: int, template, device=None):
    """The checkpoint at ``step`` in ``template``'s structure: full
    tensors with each template leaf's dtype and (global) shape, on its
    device (or on ``device``).  Raises ``ValueError`` when the leaf count,
    a shape or a dtype differs."""
    d = _step_dir(root, step)
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    paths = tree_paths(template)
    if manifest["n_leaves"] != len(paths):
        raise ValueError(
            f"checkpoint at {d} has {manifest['n_leaves']} leaves; "
            f"template expects {len(paths)}")
    index = {path: i for i, (path, _) in enumerate(paths)}

    def load(path, want):
        a = np.load(os.path.join(d, f"leaf_{index[path]}.npy"))
        got = _from_numpy(a)
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
            raise ValueError(
                f"{d} leaf {index[path]} ({'/'.join(path)}): {got.dtype}"
                f"{tuple(got.shape)}, template has {want.dtype}"
                f"{tuple(want.shape)}")
        return got.to(device if device is not None else want.device)

    return tree_map_with_path(load, template)


def restore_latest(root: str, template, device=None):
    """(step, state) of the newest published checkpoint, or (0, None)."""
    steps = published_steps(root)
    if not steps:
        return 0, None
    step = steps[-1]
    return step, restore(root, step, template, device)
