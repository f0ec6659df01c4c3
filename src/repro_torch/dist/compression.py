"""Block-wise int8 gradient compression with error feedback — port of
``repro/dist/compression.py``.

``quantize_int8`` scales each BLOCK-sized slice by its own max-abs (so one
outlier only costs its block, not the tensor) and rounds to int8
half-to-even (``torch.round``, as ``jnp.round``), bit for bit the
reference's; round-tripping is bounded by half a quantization step per
element.

``compressed_psum_leaf`` is the collective building block: the residual
from the previous round is folded in BEFORE quantization and the new
residual handed back, so the quantization error feeds forward instead of
biasing the sum — over repeated reductions the accumulated estimate stays
unbiased.  The sum is a ``torch.distributed.all_reduce`` over a process
group, where the reference ``psum``s over a mesh axis: the group of one
dimension of a ``DeviceMesh`` (``device_mesh.get_group("data")``) is
that axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize_int8(g: torch.Tensor):
    """-> (q int8 (n_blocks, BLOCK), scale float32 (n_blocks,), pad int)."""
    flat = g.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.round(blocks / scale[:, None]).to(torch.int8)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape):
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = flat.shape[0] - pad
    return flat[:n].reshape(shape)


def compressed_psum_leaf(g: torch.Tensor, residual: torch.Tensor,
                         group=None):
    """int8-compressed sum of one gradient leaf over the processes of
    ``group`` (the default group when None; a mesh axis's group, such as
    ``device_mesh.get_group("data")``, sums over that axis).

    Returns (summed dequantized gradient, new residual).  The residual is
    per-process local state the caller threads through training steps.
    Raises ``RuntimeError`` without an initialised ``torch.distributed``
    group (the reference needs a mesh axis name)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("compressed_psum_leaf needs an initialised "
                           "torch.distributed process group")
    target = g + residual
    q, scale, pad = quantize_int8(target)
    local = dequantize_int8(q, scale, pad, g.shape)
    new_residual = target - local
    total = local.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total, new_residual
