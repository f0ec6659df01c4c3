"""Indexing over states that may carry a leading lane axis.

The batched simulator runs G (config, trace) lanes at once: every field
of its cache and wear states gains a leading ``G`` axis, and every
per-request operand (set id, cycle, flag) becomes a ``(G,)`` tensor.  The
controller and wear functions serve both forms through one code path:
:func:`index` prefixes a lane index when the field has the extra axis,
:func:`put` is the reference's functional ``x.at[ix].set(v)``, and
:func:`pick` is ``jnp.where(flag, new, old)`` over a whole state with a
``(G,)`` flag.  None of them synchronises with the device.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import tree_map


def index(field: torch.Tensor, base_dim: int, *idx) -> tuple:
    """``idx`` as long tensors, prefixed with ``arange(G)`` when ``field``
    has one axis more than ``base_dim`` (the lane axis)."""
    ix = tuple(torch.as_tensor(i, device=field.device).long() for i in idx)
    if field.dim() == base_dim:
        return ix
    return (torch.arange(field.shape[0], device=field.device),) + ix


def put(field: torch.Tensor, ix: tuple, value) -> torch.Tensor:
    """A copy of ``field`` with ``value`` (a tensor or a Python scalar)
    written at ``ix``.  A scalar is filled on the field's device: a
    host-to-device copy could not be captured in a CUDA graph."""
    if not torch.is_tensor(value):
        value = torch.full((), value, dtype=field.dtype, device=field.device)
    out = field.clone()
    out[ix] = value.to(field.dtype)
    return out


def bcast(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``flag`` with trailing unit axes so it broadcasts against ``like``."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def pick(flag: torch.Tensor, new, old):
    """``where(flag, new, old)`` leaf-wise over two states; ``flag`` has
    the lane shape (``()`` or ``(G,)``)."""
    return tree_map(lambda n, o: torch.where(bcast(flag, n), n, o), new, old)


def first(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when there is
    none), as ``jnp.argmax`` over a bool row; ``torch.argmax`` has no
    bool kernel on CUDA, so the flags are cast first."""
    return torch.argmax(flags.to(torch.int32), dim=-1)
