"""The train step: bf16 compute over float32 masters, gradient
accumulation over microbatches, AdamW — port of ``repro/train/step.py``.

``TrainState = {"params": float32 master tree, "opt": {"m", "v",
"step"}}``.  Each step casts the masters by the reference's rule
(:func:`cast_bf16`: every float32 leaf of two or more dimensions to
bf16, the 1-D leaves kept float32), runs ``transformer.train_loss`` on
the cast tree and takes the gradients w.r.t. the masters with autograd.
So training computes with other dtypes than serving: a stacked group's
``ln1`` and SSM leaves are bf16 while the remainder's and ``final_ln``
stay float32, and Mamba-1's ``a_log`` is bf16 (float32 when serving).
The step runs eagerly; the reference's ``jit`` with donated state is an
in-place update here (``optimizer.adamw_update``).

Over a mesh (one process per position, the state and the batch placed
as ``DTensor``s by :func:`state_specs` and ``sharding.batch_specs``)
every process runs the same step, PyTorch's counterpart of the
reference's one GSPMD program: DTensor's sharding rules choose the
collectives, as XLA's do there, except that every move of a placed
tensor (forward, recomputation, backward and AdamW) is made by the raw
collectives of ``dist/sharding.py`` and the row-parallel products run
on each process's blocks (``layers.row_parallel``): DTensor's functional
all-gather never runs, which a gloo group of CUDA tensors does not
survive on some versions.  The step runs under DTensor's
``implicit_replication``, so the plain tensors the model builds on its
device (positions, masks, attention's running max) act as replicated
operands.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.models import transformer
from repro_torch.pytree import tree_map, tree_paths
from repro_torch.train import optimizer as opt

BF16 = torch.bfloat16
F32 = torch.float32


def cast_bf16(params: dict) -> dict:
    """The compute tree: float32 leaves with ``ndim >= 2`` as bf16, the
    others as they are (the cast is differentiable)."""
    return tree_map(lambda p: p.to(BF16) if p.dtype == F32 and p.dim() >= 2
                    else p, params)


def init_state(seed_or_generator, cfg: ArchConfig,
               device: str | torch.device = "cuda",
               device_mesh=None) -> dict:
    """A fresh train state on ``device``: ``transformer.init_params`` (its
    bf16 and float32 leaves) widened to float32 masters, zero moments,
    step 0.  ``seed_or_generator`` is an int seed or a ``torch.Generator``
    on ``device``.  With a ``device_mesh`` each master is placed by
    :func:`state_specs` as it is widened (every process draws the same
    parameters and keeps its block), and the moments are made placed."""
    dev = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        params = transformer.init_params(cfg, generator=seed_or_generator,
                                         device=dev)
    else:
        params = transformer.init_params(cfg, seed=int(seed_or_generator),
                                         device=dev)
    if device_mesh is None:
        params = tree_map(lambda p: p.to(F32), params)
    else:
        specs = sharding.param_specs(params, device_mesh)
        params = tree_map(lambda p, s: sharding.place_leaf(
            p.to(F32), s, device_mesh), params, specs)
    return {"params": params, "opt": opt.init_opt_state(params)}


def state_from_numpy(tree: dict, cfg: ArchConfig,
                     device: str | torch.device = "cuda") -> dict:
    """The reference's train state (``init_state``'s tree as numpy: float32
    leaves, an int32 step) as the port's on ``device``.  Each tree of
    ``params``, ``m`` and ``v`` must have ``transformer.param_shapes``'
    keys and shapes, in float32."""
    dev = resolve_device(device)
    want = {path: shape for path, (shape, _) in
            tree_paths(transformer.param_shapes(cfg))}

    def carry(sub, name):
        got = dict(tree_paths(sub))
        if set(got) != set(want):
            raise ValueError(f"{name} has leaves {sorted(got)}, expected "
                             f"{sorted(want)}")
        for path, a in got.items():
            if tuple(a.shape) != tuple(want[path]) or a.dtype != np.float32:
                raise ValueError(f"{name}/{'/'.join(path)}: {a.dtype}"
                                 f"{tuple(a.shape)}, expected float32"
                                 f"{tuple(want[path])}")
        return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), sub)

    step = np.asarray(tree["opt"]["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt/step: {step.dtype}{step.shape}, expected "
                         "an int32 scalar")
    return {"params": carry(tree["params"], "params"),
            "opt": {"m": carry(tree["opt"]["m"], "opt/m"),
                    "v": carry(tree["opt"]["v"], "opt/v"),
                    "step": torch.from_numpy(step.copy()).to(dev)}}


def _rows(batch: dict, lo: int, hi: int) -> dict:
    """Rows ``lo:hi`` of the GLOBAL batch; a placed leaf is placed again
    as it was (the slice may take rows that sat on other processes): its
    rows gathered whole and cut again by raw collectives
    (``sharding.redistribute``)."""
    def rows(v):
        if isinstance(v, DTensor):
            dm = v.device_mesh
            whole = [Replicate()] * dm.ndim
            part = sharding.redistribute(v, whole).to_local()[lo:hi]
            return sharding.redistribute(DTensor.from_local(
                part, dm, whole, run_check=False), v.placements)
        return v[lo:hi]
    return {k: rows(v) for k, v in batch.items()}


def _value_and_grad(cfg: ArchConfig, params: dict, batch: dict):
    """(loss, gradients in ``tree_paths`` order) of ``train_loss`` on the
    cast masters."""
    leaves = [p.detach().requires_grad_() for _, p in tree_paths(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), _sorted_like(params))
    with torch.enable_grad(), implicit_replication():
        loss = transformer.train_loss(cast_bf16(tracked), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss never reads (an audio model's token embedding) gets
    # zeros, as JAX gives it
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def loss_and_grads(cfg: ArchConfig, params: dict, batch: dict,
                   microbatches: int = 1):
    """The loss and its float32 gradients w.r.t. the masters ``params``
    (a tree like ``params``).  With ``microbatches > 1`` the batch's rows
    split into that many equal parts, the gradients are added in order
    (``0 + g0 + g1 + ...``, as the reference's scan) and the loss and
    gradients divided by the count."""
    if microbatches > 1:
        per = next(iter(batch.values())).shape[0] // microbatches
        loss, grads = None, None
        for i in range(microbatches):
            li, gi = _value_and_grad(cfg, params,
                                     _rows(batch, i * per, (i + 1) * per))
            if grads is None:
                loss, grads = li, gi
            else:
                loss = loss + li
                for acc, g in zip(grads, gi):
                    acc.add_(g)
        loss = loss / microbatches
        grads = [g / microbatches for g in grads]
    else:
        loss, grads = _value_and_grad(cfg, params, batch)
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), _sorted_like(params))


def make_train_step(cfg: ArchConfig, ocfg: opt.OptConfig = opt.OptConfig(),
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``:
    :func:`loss_and_grads`, then :func:`optimizer.adamw_update`, which
    updates the state's tensors in place.  ``metrics = {"loss", "lr",
    "grad_norm"}``, plain float32 scalars on the state's device (on a
    mesh the same on every process)."""

    def train_step(state: dict, batch: dict):
        loss, grads = loss_and_grads(cfg, state["params"], batch,
                                     microbatches)
        params, new_opt, metrics = opt.adamw_update(
            ocfg, state["params"], state["opt"], grads)
        metrics = {k: sharding.full(v)
                   for k, v in dict(metrics, loss=loss).items()}
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def state_specs(state_shapes: dict, mesh) -> dict:
    """Spec tree for a train state (``dist/sharding.py``): the masters
    and both moments share the parameter rules; the step is
    replicated."""
    p_specs = sharding.param_specs(state_shapes["params"], mesh)
    return {"params": p_specs,
            "opt": {"m": p_specs, "v": p_specs, "step": ()}}


def _sorted_like(tree):
    """``tree`` with its dict keys sorted at every level, so a
    ``tree_map`` visits leaves in :func:`tree_paths` order."""
    if isinstance(tree, dict):
        return {k: _sorted_like(tree[k]) for k in sorted(tree)}
    return tree
