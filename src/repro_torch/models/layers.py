"""Transformer layers for the serving path — port of the global-attention
parts of ``repro/models/layers.py``.  Plain functions over parameter
dicts of tensors.

Numerics follow the reference: activations and weights bf16, plain
``x @ W`` projections in bf16, and the attention and unembedding
contractions (which the reference runs with ``preferred_element_type=
float32``) computed in float32 from the bf16 values; softmax in float32
with the same ``NEG_INF`` mask and online-softmax order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

DTYPE = torch.bfloat16
NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# Init helpers.
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=DTYPE, device=None) -> torch.Tensor:
    """Normal(0, scale) weights, ``scale = fan_in ** -0.5`` by default,
    drawn in float32 from ``gen`` and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (w * scale).to(dtype)


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {
        "wq": dense_init(gen, (cfg.d_model, cfg.n_heads * cfg.d_head)),
        "wk": dense_init(gen, (cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
        "wv": dense_init(gen, (cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
        "wo": dense_init(gen, (cfg.n_heads * cfg.d_head, cfg.d_model)),
    }


def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, (cfg.d_model, d_ff)),
         "w_down": dense_init(gen, (d_ff, cfg.d_model))}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (cfg.d_model, d_ff))
    return p


def init_embed(gen: torch.Generator, cfg: ArchConfig) -> dict:
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return p


# ---------------------------------------------------------------------------
# Norms and RoPE.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm scaled by ``1 + weight`` (zero-initialised weights)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs         # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def _qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _soft_cap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def chunked_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                      q_offset: int, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh); ``q_offset`` = absolute
    position of q[0] relative to k[0]; ``window > 0`` masks to a sliding
    window.  GQA without repeating KV.  Returns (B, Sq, H, dh)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = dh ** -0.5
    kv_chunk = min(kv_chunk, skv)
    n_chunks = (skv + kv_chunk - 1) // kv_chunk
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qg = (q * scale).to(DTYPE).reshape(b, sq, kvh, rep, dh).float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, kvh, rep, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, rep, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, rep, sq, dh), dtype=torch.float32,
                      device=dev)
    for ci in range(n_chunks):
        start = ci * kv_chunk
        kc = k[:, start:start + kv_chunk].float()
        vc = v[:, start:start + kv_chunk]
        k_pos = start + torch.arange(kv_chunk, device=dev)
        logits = torch.einsum("bqgrd,bcgd->bgrqc", qg, kc)
        logits = _soft_cap(logits, softcap)
        mask = (k_pos[None, :] < skv)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window and window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqc,bcgd->bgrqd", p.to(DTYPE).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]      # (B,KVH,rep,Sq,dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return out.to(q.dtype)


def decode_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int):
    """Single-token global-attention decode: x (B, 1, D); cache_k/v
    (B, S_max, KV, dh) updated IN PLACE at ``pos`` (the reference returned
    updated copies).  Returns (out (B, 1, D), cache_k, cache_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = (x @ params["wq"]).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k_new = (x @ params["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v_new = (x @ params["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)

    s_max = cache_k.shape[1]
    kvh = cfg.n_kv_heads
    rep = cfg.n_heads // kvh
    scale = cfg.d_head ** -0.5
    qg = (q * scale).to(DTYPE).reshape(b, 1, kvh, rep, cfg.d_head)
    logits = torch.einsum("bqgrd,bcgd->bgrqc", qg.float(),
                          cache_k.to(DTYPE).float())
    logits = _soft_cap(logits, cfg.logit_softcap)
    mask = torch.arange(s_max, device=x.device) <= pos
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(DTYPE)
    out = torch.einsum("bgrqc,bcgd->bqgrd", p.float(),
                       cache_v.to(DTYPE).float()).to(x.dtype)
    out = out.reshape(b, 1, -1) @ params["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP and embeddings.
# ---------------------------------------------------------------------------

def mlp_block(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    up = x @ params["w_up"]
    if cfg.mlp_gated:
        up = F.silu(x @ params["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return up @ params["w_down"]


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) bf16 -> (B, S, V) float32 logits."""
    w = params.get("unembed")
    if w is None:
        w = params["embed"].T
    return torch.einsum("bsd,dv->bsv", x.float(), w.float())
