"""Serving steps: prefill and single-token greedy decode (port of
``repro/serve/step.py``).  PyTorch runs eagerly, so these are plain
closures over the model functions; on placed parameters (a mesh) they
run on placed tensors as the model functions do."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
from repro_torch.models import transformer


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The (B, 1) argmax tokens of (B, V) logits; placed logits have
    their vocabulary gathered first by the raw all-gather
    (``sharding.replicate_dim``: DTensor's argmax over a split dimension
    fails on some versions), so the tokens are the first argmax of the
    whole row, and keep their rows' placements."""
    if isinstance(logits, DTensor):
        logits = sharding.replicate_dim(logits, -1)
    return torch.argmax(logits, dim=-1)[:, None]


def make_prefill_step(cfg: ArchConfig, max_seq: int):
    def prefill_step(params, batch):
        return transformer.prefill(params, cfg, batch, max_seq)
    return prefill_step


def make_resume_prefill_step(cfg: ArchConfig, max_seq: int):
    """Prefill-from-offset for the prefix-cache resume path: ``prefix_kv``
    holds the cached prefix's post-RoPE k/v (None = full prefill) and
    ``batch`` only the suffix tokens.  Always returns ``(last-token
    logits, decode cache, kv-of-this-call)``."""
    def resume_prefill_step(params, batch, prefix_kv=None):
        return transformer.prefill(params, cfg, batch, max_seq,
                                   prefix_kv=prefix_kv, return_kv=True)
    return resume_prefill_step


def make_decode_step(cfg: ArchConfig, on_logits=None):
    """A greedy decode step; ``on_logits(logits)``, if given, sees each
    step's logits before the argmax."""
    def serve_step(params, cache, tokens, pos):
        """tokens: (B, 1); pos: int.  Returns (next_tokens (B, 1) int64,
        logits (B, V) float32, cache updated in place)."""
        logits, cache = transformer.decode_step(params, cfg, tokens, cache,
                                                pos)
        if on_logits is not None:
            on_logits(logits)
        return greedy(logits), logits, cache
    return serve_step
