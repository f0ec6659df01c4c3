"""Seeded weights, made on the device in the program's parameter layout.

The layout (every leaf's shape and type) is the program's
``transformer.param_shapes``; the values are the benchmark's own, drawn
from a ``torch.Generator`` on the card in a few large calls (one a leaf,
in slices of at most ``SLICE`` values), in the type they are served in.
The same tensors go to the program and to the reference.

Matrices are normal with ``fan_in ** -0.5`` (the embedding 0.02, the
Mamba-2 ``wdt`` 0.02 and ``conv_w`` 0.5, as trained models of these
families start); norm weights, ``conv_b`` and ``d_skip`` are drawn
around their neutral values so that the reference's handling of each is
exercised; ``a_log`` and ``dt_b`` span Mamba-2's usual ranges.
"""
from __future__ import annotations

import math

import torch

#: Most values one random call makes (its float32 buffer is 4 bytes each).
SLICE = 1 << 28

_FIXED_SCALE = {"embed": 0.02, "wdt": 0.02, "conv_w": 0.5}
_NORMS = ("ln1", "ln2", "final_ln", "norm_w")


def _fill(out: torch.Tensor, draw) -> torch.Tensor:
    """``out`` filled slice by slice along its first axis with
    ``draw(shape)`` (float32), cast to ``out``'s type."""
    flat = out.view(out.shape[0], -1) if out.dim() > 1 else out.view(1, -1)
    per = max(1, SLICE // max(flat.shape[1], 1))
    for lo in range(0, flat.shape[0], per):
        hi = min(lo + per, flat.shape[0])
        flat[lo:hi] = draw((hi - lo, flat.shape[1])).to(out.dtype)
    return out


def leaf(gen: torch.Generator, name: str, shape: tuple, dtype,
         device) -> torch.Tensor:
    """One leaf ``name`` of ``shape`` (stacked leaves lead with the
    group axis; a matrix's fan-in is its second-to-last axis)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    normal = lambda s: torch.randn(s, generator=gen, device=device)
    uniform = lambda s: torch.rand(s, generator=gen, device=device)
    if name in _NORMS or name == "conv_b":
        return _fill(out, lambda s: 0.1 * normal(s))
    if name == "d_skip":
        return _fill(out, lambda s: 0.5 + uniform(s))
    if name == "a_log":                      # A in [-16, -1]
        return _fill(out, lambda s: torch.log(1 + 15 * uniform(s)))
    if name == "dt_b":                       # softplus(dt_b) in [1e-3, 0.1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        return _fill(out, lambda s: torch.log(torch.expm1(
            torch.exp(lo + (hi - lo) * uniform(s)))))
    scale = _FIXED_SCALE.get(name, shape[-2] ** -0.5 if len(shape) >= 2
                             else 1.0)
    return _fill(out, lambda s: scale * normal(s))


def make(cfg, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` (an ``ArchConfig``) on ``device``,
    drawn from ``seed``."""
    from repro_torch.models import transformer
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape, dtype = tree
        return leaf(gen, name, tuple(shape), dtype, device)

    return walk(transformer.param_shapes(cfg))
