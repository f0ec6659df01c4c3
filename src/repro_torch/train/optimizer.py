"""AdamW with float32 master parameters, global-norm clipping and a
linear-warmup + cosine-decay schedule — port of
``repro/train/optimizer.py``.

The arithmetic is the reference's, in its order, on float32 tensors:
``m = b1*m + (1-b1)*g``, ``v = b2*v + ((1-b2)*g)*g``, the bias
corrections from the float32 step, ``delta = m_hat / (sqrt(v_hat) +
eps)``, plus ``wd * p`` where :func:`_decay_mask` and ``ndim >= 2``
allow, then ``p - lr * delta``.  (``torch.optim.AdamW`` decouples the
decay and places the bias corrections elsewhere: another function.)
Leaves are updated IN PLACE under ``torch.no_grad()`` — the reference
donates its state, so one copy of params, m and v is resident — and sums
over leaves run in the reference's leaf order (dict keys sorted).
Placed over a mesh (``DTensor`` leaves), each gradient is first
redistributed to its parameter's placements (a data-parallel gradient
arrives as a partial sum: this is the gradient all-reduce), and the
global norm is over every shard.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.dist import sharding
from repro_torch.pytree import tree_map, tree_map_with_path, tree_paths

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or integer tensor), float32."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1),
                                     max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params_fp32: dict) -> dict:
    """Zero float32 moments beside each master, and the int32 step."""
    zeros = lambda p: torch.zeros_like(p, dtype=F32)
    first = tree_paths(params_fp32)[0][1]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):         # replicated over the mesh
        step = DTensor.from_local(
            step, first.device_mesh, [Replicate()] * first.device_mesh.ndim,
            run_check=False)
    return {"m": tree_map(zeros, params_fp32),
            "v": tree_map(zeros, params_fp32), "step": step}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf in float32, the leaves
    added in the reference's (sorted-key) order."""
    total = 0
    for _, x in tree_paths(tree):
        total = total + torch.sum(x.to(F32) ** 2)
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


def _decay_mask(path: tuple) -> bool:
    """No weight decay on norms, biases and the SSM's per-channel leaves,
    keyed on the leaf's name as the reference keys it (so a stacked
    leaf's own ``ndim >= 2`` still decides in :func:`adamw_update`)."""
    return path[-1] not in ("ln1", "ln2", "final_ln", "norm_w", "conv_b",
                            "dt_b", "d_skip")


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, opt_state: dict,
                 grads: dict):
    """One AdamW step.  Returns ``(params, opt_state, metrics)`` with
    ``metrics = {"lr", "grad_norm"}``.  ``params`` and the moments are
    updated IN PLACE and returned; ``grads`` is not changed."""
    with implicit_replication():
        return _adamw_update(cfg, params, opt_state, grads)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` redistributed to ``p``'s placements when ``p`` is placed (an
    in-place update takes no mixed placements), by raw collectives
    (``sharding.redistribute``)."""
    if isinstance(p, DTensor):
        return sharding.redistribute(g, p.placements)
    return g


def _adamw_update(cfg: OptConfig, params: dict, opt_state: dict,
                  grads: dict):
    p_of = dict(tree_paths(params))
    grads = tree_map_with_path(lambda path, g: _placed_like(
        g, p_of[path]), grads)
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    step_f = step.to(F32)
    b1c = 1 - cfg.b1 ** step_f
    b2c = 1 - cfg.b2 ** step_f
    m_tree, v_tree = opt_state["m"], opt_state["v"]
    m_of = dict(tree_paths(m_tree))
    v_of = dict(tree_paths(v_tree))
    g_of = dict(tree_paths(grads))
    for path, p in tree_paths(params):
        m, v, g = m_of[path], v_of[path], g_of[path].to(F32)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if _decay_mask(path) and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p
        p.sub_(lr * delta)
    return params, {"m": m_tree, "v": v_tree, "step": step}, {
        "lr": lr, "grad_norm": gn}
