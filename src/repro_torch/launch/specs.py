"""Input factories on the ``meta`` device for every (arch x shape) cell
(port of ``repro/launch/specs.py``).

A ``meta`` tensor has a shape and a dtype and no storage: the counterpart
of ``jax.ShapeDtypeStruct``.  Nothing here allocates, so the full
configurations can be described on any host; the dry run
(``launch/dryrun.py``) runs each step on these.  Modality frontends are
stubs: ``[vlm]``/``[audio]`` cells receive precomputed patch/frame
embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.pytree import tree_map
from repro_torch.train import optimizer as opt

META = torch.device("meta")
BF16 = torch.bfloat16
I32 = torch.int32
F32 = torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        p = cfg.n_prefix_embeds
        return {
            "embeds": _meta((b, p, cfg.d_model), BF16),
            "tokens": _meta((b, s - p), I32),
            "labels": _meta((b, s - p), I32),
        }
    if cfg.family == "audio":
        return {
            "embeds": _meta((b, s, cfg.d_model), BF16),
            "labels": _meta((b, s), I32),
        }
    return {
        "tokens": _meta((b, s), I32),
        "labels": _meta((b, s), I32),
    }


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    spec = train_batch_specs(cfg, shape)
    spec.pop("labels", None)
    return spec


def decode_arg_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(cache, tokens, pos) for the decode step: the cache
    ``transformer.init_cache`` builds, (B, 1) int32 tokens and an int32
    scalar position."""
    b, s = shape.global_batch, shape.seq_len
    cache = transformer.init_cache(cfg, b, s, device=META)
    return cache, _meta((b, 1), I32), _meta((), I32)


def params_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree, its leaves ``transformer.param_shapes``'
    shapes and dtypes (``init_params`` draws from a ``torch.Generator``,
    which the meta device has none of)."""
    return tree_map(lambda leaf: _meta(*leaf), transformer.param_shapes(cfg))


def state_shapes(cfg: ArchConfig) -> dict:
    """The train state ``train/step.py`` ``init_state`` builds: float32
    masters, zero float32 moments, an int32 step."""
    params = tree_map(lambda p: p.to(F32), params_shapes(cfg))
    return {"params": params, "opt": opt.init_opt_state(params)}


def bf16_params_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree with every bf16 and float32 leaf as bf16."""
    return tree_map(lambda p: p.to(BF16) if p.dtype in (BF16, F32) else p,
                    params_shapes(cfg))
