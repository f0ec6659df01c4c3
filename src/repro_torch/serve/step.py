"""Serving steps: prefill and single-token greedy decode (port of
``repro/serve/step.py``).  PyTorch runs eagerly, so these are plain
closures over the model functions."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


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


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, pos):
        """tokens: (B, 1); pos: int.  Returns (next_tokens (B, 1) int64,
        logits (B, V) float32, cache updated in place)."""
        logits, cache = transformer.decode_step(params, cfg, tokens, cache,
                                                pos)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        return nxt, logits, cache
    return serve_step
