"""Decoder stack for the serving path — port of the attention parts of
``repro/models/transformer.py`` (global and sliding-window local
attention layers, each followed by a dense MLP or an MoE block).

Parameters keep the reference's tree so tests compare leaf by leaf.  The
layer pattern is factored by ``cfg.scan_groups()`` into ``n_groups``
repeats of a group of block kinds plus an unstacked remainder; block ``i``
of the group is stacked over the groups on a leading axis, the remainder
blocks are not::

    {"embed": {"embed": (V, D), "unembed": (D, V)}, "final_ln": (D,),
     "groups": {"b0": {"ln1": (G, D), "ln2": (G, D),
                       "attn": {"wq", "wk", "wv", "wo"}: (G, ...),
                       "mlp": {"w_up", "w_gate", "w_down"}: (G, ...)},
                       # or, with cfg.n_experts, "moe": {"router",
                       #   "w_up", "w_gate", "w_down"[, "dense"]}
                "b1": ..., },
     "rem0": {"ln1": (D,), ...}, "rem1": ...}

An all-global model (yi-9b) is one ``b0`` group per layer and no
remainder; gemma3-27b's 62 layers are 10 groups of [local x 5, global]
plus ``rem0``, ``rem1`` (both local).  Caches and KV trees have the same
keys with ``{"k", "v"}`` leaves (G, B, S, KV, dh) in a group and
(B, S, KV, dh) in the remainder; a local block's decode cache is a ring
of ``min(max_seq, sliding_window)`` slots.  The reference's ``lax.scan``
over the groups is a Python loop.  SSM and shared-attention blocks are
not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ArchConfig)
from repro_torch.device import resolve_device
from repro_torch.models import layers, moe
from repro_torch.pytree import tree_leaves, tree_map

DTYPE = layers.DTYPE

_NOT_PORTED = ("not ported yet (ROADMAP.md, Queue 1 item 4: SSM and shared "
               "attention, and the training forward): the port runs global "
               "and local attention layers with dense MLP or MoE blocks")


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.layer_pattern())
    if not kinds <= {ATTN_GLOBAL, ATTN_LOCAL}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} are {_NOT_PORTED}")


def _blocks(cfg: ArchConfig):
    """Every layer in stack order as ``(key, g, kind)``: ``("b{i}", g,
    kind)`` for block i of group g, then ``("rem{i}", None, kind)``."""
    group, n_groups, rem = cfg.scan_groups()
    for g in range(n_groups):
        for i, kind in enumerate(group):
            yield f"b{i}", g, kind
    for i, kind in enumerate(rem):
        yield f"rem{i}", None, kind


def _block(tree: dict, key: str, g: int | None) -> dict:
    """The block ``key`` of a parameter, cache or KV tree, at group ``g``
    (a view into the stacked leaves) or in the remainder."""
    if g is None:
        return tree[key]
    return tree_map(lambda a: a[g], tree["groups"][key])


def _stacked(cfg: ArchConfig, fn) -> dict:
    """A tree with ``fn(kind, lead)`` for each block: ``lead = (G,)`` for
    the group's blocks and ``()`` for the remainder's."""
    group, n_groups, rem = cfg.scan_groups()
    out = {}
    if n_groups > 0:
        out["groups"] = {f"b{i}": fn(kind, (n_groups,))
                         for i, kind in enumerate(group)}
    for i, kind in enumerate(rem):
        out[f"rem{i}"] = fn(kind, ())
    return out


def param_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree's leaf shapes (group axis leading in
    ``groups``)."""
    _check_supported(cfg)
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    embed = {"embed": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = (d, cfg.vocab_size)

    def block(kind, lead):
        out = {"ln1": lead + (d,),
               "attn": {"wq": lead + (d, hd), "wk": lead + (d, kvd),
                        "wv": lead + (d, kvd), "wo": lead + (hd, d)},
               "ln2": lead + (d,)}
        if cfg.n_experts:
            out["moe"] = moe.moe_shapes(cfg, lead)
            return out
        mlp = {"w_up": lead + (d, cfg.d_ff), "w_down": lead + (cfg.d_ff, d)}
        if cfg.mlp_gated:
            mlp["w_gate"] = lead + (d, cfg.d_ff)
        out["mlp"] = mlp
        return out

    return {"embed": embed, "final_ln": (d,), **_stacked(cfg, block)}


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters on ``device`` from a seeded ``torch.Generator``
    on that device, with the reference's ``dense_init`` scales
    (``fan_in ** -0.5``, 0.02 for the embedding and the MoE router, zero
    norm weights).  The
    bits differ from JAX's; tests carry JAX's weights across with
    :func:`params_from_numpy` instead.  Layers are drawn one at a time so
    the float32 draw never holds more than one layer's leaf."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def fill(path, shape):
        if path[-1] in ("ln1", "ln2", "final_ln"):
            return torch.zeros(shape, dtype=DTYPE, device=dev)
        scale = 0.02 if path[-1] in ("embed", "router") else None
        if path[0] != "groups":               # embedding or remainder
            return layers.dense_init(gen, shape, scale=scale, device=dev)
        out = torch.empty(shape, dtype=DTYPE, device=dev)
        for i in range(shape[0]):             # stacked: one layer at a time
            out[i] = layers.dense_init(gen, shape[1:], scale=scale,
                                       device=dev)
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


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens, device=device).long()


def _embed_scaled(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    # sqrt(d_model) rounded to bf16 on the host, as the reference's bf16
    # constant (a scalar tensor made on the card would block the host)
    scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=DTYPE))
    return layers.embed(params["embed"], tokens) * scale


# ---------------------------------------------------------------------------
# Decode caches, prefill and decode.
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> dict:
    _check_supported(cfg)
    device = resolve_device(device)

    def block(kind, lead):                # a local block keeps a ring
        slots = (min(max_seq, cfg.sliding_window) if kind == ATTN_LOCAL
                 else max_seq)
        shape = lead + (batch, slots, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=DTYPE, device=device),
                "v": torch.zeros(shape, dtype=DTYPE, device=device)}

    return _stacked(cfg, block)


def resume_supported(cfg: ArchConfig) -> bool:
    """True when every layer's decode state is reconstructible from
    per-position KV (attention only)."""
    return all(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_pattern())


def prefix_length(prefix_kv: dict) -> int:
    """Token length P of a ``prefix_kv`` tree (seq axis third-from-last)."""
    leaf = tree_leaves(prefix_kv)[0]
    return leaf.shape[leaf.dim() - 3]


def _write_cache(bc: dict, k_all: torch.Tensor, v_all: torch.Tensor,
                 local: bool) -> None:
    """Fill a block's decode cache with the k/v of all ``s_tot`` tokens so
    far: the first ``s_tot`` slots of a global cache, or the last
    ``min(W, s_tot)`` tokens at their ring slots ``position % W``."""
    s_tot = k_all.shape[1]
    if local:
        w = bc["k"].shape[1]
        take = min(w, s_tot)
        slots = torch.arange(s_tot - take, s_tot, device=k_all.device) % w
        bc["k"][:, slots] = k_all[:, s_tot - take:].to(DTYPE)
        bc["v"][:, slots] = v_all[:, s_tot - take:].to(DTYPE)
    else:
        bc["k"][:, :s_tot] = k_all.to(DTYPE)
        bc["v"][:, :s_tot] = v_all.to(DTYPE)


def _ffn(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A block's feed-forward half: its MoE block, or its dense MLP."""
    if "moe" in p:
        return moe.moe_block(p["moe"], h, cfg)
    return layers.mlp_block(p["mlp"], h, cfg)


def _apply_block(p: dict, cfg: ArchConfig, key: str, g: int | None,
                 x: torch.Tensor, x32: torch.Tensor | None, attend):
    """One attention block, ``x + attend(norm(x))`` then ``+ ffn(norm)``
    (the MLP, or the MoE block of an MoE config);
    returns the bf16 residual and, inside a group, its float32 sum.

    Inside a group each norm reads the float32 sum of the residual add
    before it, not its bf16 rounding, as the reference's compiled scan
    body does: XLA drops the bf16 round trip between an add and the
    float32 norm within one compiled body.  So ``x32`` carries the
    previous block's sum within one group iteration; the first block of
    an iteration reads the bf16 scan carry, and the remainder blocks,
    which the reference runs op by op, round every add."""
    fused = g is not None
    h = layers.rms_norm(x32 if fused and key != "b0" else x,
                        p["ln1"]).to(DTYPE)
    s1 = x.float() + attend(h).float()
    x = s1.to(DTYPE)
    h2 = layers.rms_norm(s1 if fused else x, p["ln2"]).to(DTYPE)
    s2 = x.float() + _ffn(p, h2, cfg).float()
    return s2.to(DTYPE), s2 if fused else None


def prefill(params: dict, cfg: ArchConfig, batch: dict, max_seq: int, *,
            prefix_kv: dict | None = None, return_kv: bool = False):
    """Run the stack over a prompt and build the decode cache.  Returns
    (last-token logits (B, V) float32, cache), plus the per-layer KV of
    THIS call's tokens when ``return_kv``.

    ``prefix_kv`` resumes from a cached prefix (post-RoPE k/v of the first
    P prompt tokens, every layer): ``batch["tokens"]`` then holds only the
    suffix, whose positions start at P, and attention runs over prefix ++
    suffix with ``q_offset=P`` — the same cache and logits as a full
    prefill.  Local layers attend within the sliding window and keep the
    last ``min(W, P + S)`` keys in their ring."""
    _check_supported(cfg)
    dev = _device_of(params)
    toks = _tokens(batch["tokens"], dev)
    x = _embed_scaled(params, cfg, toks)
    b, s, _ = x.shape
    p_len = 0 if prefix_kv is None else prefix_length(prefix_kv)
    positions = (torch.arange(s, device=dev) + p_len)[None].expand(b, s)
    cache = init_cache(cfg, b, max_seq, dev)

    def kv_block(kind, lead):
        shape = lead + (b, s, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.empty(shape, dtype=DTYPE, device=dev),
                "v": torch.empty(shape, dtype=DTYPE, device=dev)}

    kv_out = _stacked(cfg, kv_block) if return_kv else None
    x32 = None
    for key, g, kind in _blocks(cfg):
        local = kind == ATTN_LOCAL
        p = _block(params, key, g)

        def attend(h):
            q, k, v = layers._qkv(p["attn"], h, cfg, positions)
            if prefix_kv is not None:
                pk = _block(prefix_kv, key, g)
                k_all = torch.cat([pk["k"].to(k.dtype), k], dim=1)
                v_all = torch.cat([pk["v"].to(v.dtype), v], dim=1)
            else:
                k_all, v_all = k, v
            out = layers.chunked_attention(
                q, k_all, v_all, causal=cfg.causal and not cfg.encoder_only,
                window=cfg.sliding_window if local else 0,
                softcap=cfg.logit_softcap, q_offset=p_len)
            _write_cache(_block(cache, key, g), k_all, v_all, local)
            if return_kv:
                kv = _block(kv_out, key, g)
                kv["k"].copy_(k)
                kv["v"].copy_(v)
            return out.reshape(b, s, -1) @ p["attn"]["wo"]

        x, x32 = _apply_block(p, cfg, key, g, x, x32, attend)
    x = layers.rms_norm(x, params["final_ln"])
    logits = layers.unembed_logits(params["embed"], x[:, -1:])[:, 0]
    if return_kv:
        return logits, cache, kv_out
    return logits, cache


def decode_step(params: dict, cfg: ArchConfig, tokens, cache: dict,
                pos: int):
    """tokens: (B, 1) int; pos: the new token's position.  Returns
    (logits (B, V) float32, cache), the cache updated in place: a global
    block writes slot ``pos``, a local block its ring slot ``pos % W``."""
    _check_supported(cfg)
    dev = _device_of(params)
    x = _embed_scaled(params, cfg, _tokens(tokens, dev))
    pos = int(pos)
    x32 = None
    for key, g, kind in _blocks(cfg):
        p = _block(params, key, g)
        bc = _block(cache, key, g)

        def attend(h):
            if kind == ATTN_LOCAL:
                w = bc["k"].shape[1]
                out, _, _ = layers.decode_attention_ring(
                    p["attn"], h, cfg, bc["k"], bc["v"], pos, pos % w)
            else:
                out, _, _ = layers.decode_attention(
                    p["attn"], h, cfg, bc["k"], bc["v"], pos)
            return out

        x, x32 = _apply_block(p, cfg, key, g, x, x32, attend)
    x = layers.rms_norm(x, params["final_ln"])
    logits = layers.unembed_logits(params["embed"], x)[:, 0]
    return logits, cache
