"""Decoder stack for the serving path — port of the global-attention parts
of ``repro/models/transformer.py``.

Parameters keep the reference's tree so tests compare leaf by leaf: the
repeating layer group is stacked on a leading axis, which for an
all-global-attention model is one ``ATTN_GLOBAL`` block per layer::

    {"embed": {"embed": (V, D), "unembed": (D, V)}, "final_ln": (D,),
     "groups": {"b0": {"ln1": (L, D), "ln2": (L, D),
                       "attn": {"wq", "wk", "wv", "wo"}: (L, ...),
                       "mlp": {"w_up", "w_gate", "w_down"}: (L, ...)}}}

and caches / KV trees are ``{"groups": {"b0": {"k", "v"}}}`` with leaves
(L, B, S, KV, dh).  The reference's ``lax.scan`` over the group axis is a
Python loop over layers.  MoE, SSM, local (sliding-window) and shared
attention blocks are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ArchConfig)
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.pytree import tree_leaves, tree_map

DTYPE = layers.DTYPE

_NOT_PORTED = ("not ported yet (ROADMAP.md, port queue): the port runs "
               "all-global-attention dense models")


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.layer_pattern())
    if kinds != {ATTN_GLOBAL} or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}"
            f"{' with MoE' if cfg.n_experts else ''} are {_NOT_PORTED}")


def param_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree's leaf shapes (layer axis leading)."""
    _check_supported(cfg)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    embed = {"embed": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = (d, cfg.vocab_size)
    mlp = {"w_up": (L, d, cfg.d_ff), "w_down": (L, cfg.d_ff, d)}
    if cfg.mlp_gated:
        mlp["w_gate"] = (L, d, cfg.d_ff)
    block = {"ln1": (L, d),
             "attn": {"wq": (L, d, hd), "wk": (L, d, kvd),
                      "wv": (L, d, kvd), "wo": (L, hd, d)},
             "ln2": (L, d), "mlp": mlp}
    return {"embed": embed, "final_ln": (d,), "groups": {"b0": block}}


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters on ``device`` from a seeded ``torch.Generator``
    on that device, with the reference's ``dense_init`` scales
    (``fan_in ** -0.5``, 0.02 for the embedding, zero norm weights).  The
    bits differ from JAX's; tests carry JAX's weights across with
    :func:`params_from_numpy` instead.  Layers are drawn one at a time so
    the float32 draw never holds more than one layer."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def fill(path, shape):
        if path[-1] in ("ln1", "ln2", "final_ln"):
            return torch.zeros(shape, dtype=DTYPE, device=dev)
        if path[0] == "embed":
            scale = 0.02 if path[-1] == "embed" else None
            return layers.dense_init(gen, shape, scale=scale, device=dev)
        out = torch.empty(shape, dtype=DTYPE, device=dev)
        for i in range(shape[0]):             # stacked: one layer at a time
            out[i] = layers.dense_init(gen, shape[1:], device=dev)
        return out

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return fill(path, tree)

    return walk(shapes)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                  # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree, given as numpy arrays (bf16 as
    ``ml_dtypes.bfloat16``), as the port's parameters on ``device``.
    Keys and shapes must match :func:`param_shapes` exactly."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def walk(t, s, path=()):
        if isinstance(s, dict):
            if not isinstance(t, dict) or set(t) != set(s):
                raise ValueError(f"parameter tree at {'/'.join(path) or '/'} "
                                 f"has keys {sorted(t) if isinstance(t, dict) else t}"
                                 f", expected {sorted(s)}")
            return {k: walk(t[k], s[k], path + (k,)) for k in s}
        if tuple(t.shape) != tuple(s):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, "
                             f"expected {tuple(s)}")
        return _to_tensor(t, dev)

    return walk(tree, shapes)


def param_count(params: dict) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _device_of(params: dict) -> torch.device:
    return params["final_ln"].device


def _layer(tree: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], tree)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens, device=device).long()


def _embed_scaled(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=DTYPE,
                         device=tokens.device)
    return layers.embed(params["embed"], tokens) * scale


# ---------------------------------------------------------------------------
# Decode caches, prefill and decode.
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> dict:
    _check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    z = lambda: torch.zeros(shape, dtype=DTYPE, device=device)
    return {"groups": {"b0": {"k": z(), "v": z()}}}


def resume_supported(cfg: ArchConfig) -> bool:
    """True when every layer's decode state is reconstructible from
    per-position KV (attention only)."""
    return all(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_pattern())


def prefix_length(prefix_kv: dict) -> int:
    """Token length P of a ``prefix_kv`` tree (seq axis third-from-last)."""
    leaf = tree_leaves(prefix_kv)[0]
    return leaf.shape[leaf.dim() - 3]


def prefill(params: dict, cfg: ArchConfig, batch: dict, max_seq: int, *,
            prefix_kv: dict | None = None, return_kv: bool = False):
    """Run the stack over a prompt and build the decode cache.  Returns
    (last-token logits (B, V) float32, cache), plus the per-layer KV of
    THIS call's tokens when ``return_kv``.

    ``prefix_kv`` resumes from a cached prefix (post-RoPE k/v of the first
    P prompt tokens): ``batch["tokens"]`` then holds only the suffix,
    whose positions start at P, and attention runs over prefix ++ suffix
    with ``q_offset=P`` — the same cache and logits as a full prefill."""
    _check_supported(cfg)
    dev = _device_of(params)
    toks = _tokens(batch["tokens"], dev)
    x = _embed_scaled(params, cfg, toks)
    b, s, _ = x.shape
    p_len = 0 if prefix_kv is None else prefix_length(prefix_kv)
    positions = (torch.arange(s, device=dev) + p_len)[None].expand(b, s)
    cache = init_cache(cfg, b, max_seq, dev)
    ck_all, cv_all = cache["groups"]["b0"]["k"], cache["groups"]["b0"]["v"]
    kv_k = torch.empty((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head),
                       dtype=DTYPE, device=dev)
    kv_v = torch.empty_like(kv_k)
    gp = params["groups"]["b0"]
    for i in range(cfg.n_layers):
        p = _layer(gp, i)
        h = layers.rms_norm(x, p["ln1"])
        q, k, v = layers._qkv(p["attn"], h, cfg, positions)
        if prefix_kv is not None:
            pk = prefix_kv["groups"]["b0"]
            k_all = torch.cat([pk["k"][i].to(k.dtype), k], dim=1)
            v_all = torch.cat([pk["v"][i].to(v.dtype), v], dim=1)
        else:
            k_all, v_all = k, v
        out = layers.chunked_attention(
            q, k_all, v_all, causal=cfg.causal and not cfg.encoder_only,
            window=0, softcap=cfg.logit_softcap, q_offset=p_len)
        x = x + out.reshape(b, s, -1) @ p["attn"]["wo"]
        h2 = layers.rms_norm(x, p["ln2"])
        x = x + layers.mlp_block(p["mlp"], h2, cfg)
        s_tot = k_all.shape[1]
        ck_all[i, :, :s_tot] = k_all.to(DTYPE)
        cv_all[i, :, :s_tot] = v_all.to(DTYPE)
        kv_k[i] = k.to(DTYPE)
        kv_v[i] = v.to(DTYPE)
    x = layers.rms_norm(x, params["final_ln"])
    logits = layers.unembed_logits(params["embed"], x[:, -1:])[:, 0]
    if return_kv:
        return logits, cache, {"groups": {"b0": {"k": kv_k, "v": kv_v}}}
    return logits, cache


def decode_step(params: dict, cfg: ArchConfig, tokens, cache: dict,
                pos: int):
    """tokens: (B, 1) int; pos: the new token's position.  Returns
    (logits (B, V) float32, cache), the cache updated in place."""
    _check_supported(cfg)
    dev = _device_of(params)
    x = _embed_scaled(params, cfg, _tokens(tokens, dev))
    gp = params["groups"]["b0"]
    ck_all, cv_all = cache["groups"]["b0"]["k"], cache["groups"]["b0"]["v"]
    pos = int(pos)
    for i in range(cfg.n_layers):
        p = _layer(gp, i)
        h = layers.rms_norm(x, p["ln1"])
        out, _, _ = layers.decode_attention(p["attn"], h, cfg, ck_all[i],
                                            cv_all[i], pos)
        x = x + out
        h2 = layers.rms_norm(x, p["ln2"])
        x = x + layers.mlp_block(p["mlp"], h2, cfg)
    x = layers.rms_norm(x, params["final_ln"])
    logits = layers.unembed_logits(params["embed"], x)[:, 0]
    return logits, cache
