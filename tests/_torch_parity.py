"""Helpers shared by the port's parity tests: an exact-equality walk of a
JAX reference dataclass and its port counterpart, field by field, and a
plain-cache decode that is the oracle of the ring decode (numpy and torch
only, so the card-only tests can use it too)."""
from __future__ import annotations

import dataclasses

import numpy as np


def assert_tree_equal(want, got, path: str = "") -> None:
    """Every leaf of ``got`` (torch) equals the same-named leaf of ``want``
    (JAX), with the same shape and dtype."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_tree_equal(getattr(want, f.name), getattr(got, f.name),
                              f"{path}.{f.name}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_tree_equal(w, g, f"{path}[{i}]")
        return
    w = np.asarray(want)
    g = got.cpu().numpy()
    assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=path)


def plain_cache_decode(params: dict, cfg, tokens: np.ndarray, n: int):
    """Greedy decode of ``n`` tokens after ``tokens`` (B, S) with a plain
    cache of S + n slots in every block, the local blocks masked to the
    window (``layers.decode_attention(local=True)``): the oracle of the
    ring decode, whose only difference is the slot order.  Returns the
    per-step logits and the fed tokens."""
    import torch

    from repro_torch.configs.base import ATTN_LOCAL
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.pytree import tree_map

    s = tokens.shape[1]
    logits, _, kv = tf.prefill(params, cfg, {"tokens": tokens}, s + n,
                               return_kv=True)
    cache = tree_map(lambda a: torch.cat(
        [a, torch.zeros_like(a[..., :n, :, :])], dim=a.dim() - 3), kv)
    steps, fed = [], []
    for t in range(n):
        nxt = logits.argmax(-1)[:, None]
        fed.append(nxt)
        x = tf._embed_scaled(params, cfg, nxt)
        x32 = None
        for key, g, kind in tf._blocks(cfg):
            p, bc = tf._block(params, key, g), tf._block(cache, key, g)

            def attend(h):
                return layers.decode_attention(
                    p["attn"], h, cfg, bc["k"], bc["v"], s + t,
                    local=kind == ATTN_LOCAL)[0]

            x, x32 = tf._apply_block(p, cfg, kind, key, g, x, x32, attend)
        x = layers.rms_norm(x, params["final_ln"])
        logits = layers.unembed_logits(params["embed"], x)[:, 0]
        steps.append(logits)
    return steps, torch.cat(fed, dim=1)
