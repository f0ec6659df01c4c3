"""Transformer layers — port of ``repro/models/layers.py`` (global and
sliding-window local attention, the ring-buffer decode, the MLPs, the
embeddings and the chunked cross-entropy loss).  Plain functions over
parameter dicts of tensors.

Numerics follow the reference: activations and weights bf16, plain
``x @ W`` projections in bf16, and the attention and unembedding
contractions (which the reference runs with ``preferred_element_type=
float32``) computed in float32 from the bf16 values; softmax in float32
with the same ``NEG_INF`` mask and online-softmax order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding

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


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """``q * d_head ** -0.5`` with the scale itself rounded to ``q``'s
    dtype first, as JAX casts a Python scalar to the array's dtype (torch
    would multiply by the exact float).  The rounding happens on the host:
    a scalar tensor made on the card would be a blocking copy per layer."""
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))
    return q * scale


def chunked_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                      q_offset: int, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh); ``q_offset`` = absolute
    position of q[0] relative to k[0]; ``window > 0`` masks to a sliding
    window.  GQA without repeating KV.  Returns (B, Sq, H, dh)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    kv_chunk = min(kv_chunk, skv)
    n_chunks = (skv + kv_chunk - 1) // kv_chunk
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qg = _scaled(q).to(DTYPE).reshape(b, sq, kvh, rep, dh).float()
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


def _seq_shard(t: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """With ``cfg.attn_seq_shard`` (the data axes), pin (B, S, ...)
    activations placed over a mesh to (dp, "model", None, ...), so the
    attention contractions keep whole heads (no float32 logits summed
    over ``model``) at the cost of gathering KV chunks over ``model``.
    A plain tensor (one process) is returned as it is."""
    axes = tuple(cfg.attn_seq_shard or ())
    if not axes:
        return t
    return sharding.constrain(t, (axes, "model"))


def attention_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, *, local: bool,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Self-attention over x (B, S, D); ``local`` masks to the sliding
    window."""
    q, k, v = _qkv(params, x, cfg, positions)
    q, k, v = _seq_shard(q, cfg), _seq_shard(k, cfg), _seq_shard(v, cfg)
    out = chunked_attention(
        q, k, v, causal=cfg.causal and not cfg.encoder_only,
        window=cfg.sliding_window if local else 0,
        softcap=cfg.logit_softcap, q_offset=0, kv_chunk=kv_chunk)
    b, s = out.shape[:2]
    return _seq_shard(out.reshape(b, s, -1) @ params["wo"], cfg)


def _decode_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig, pos: int):
    """q, k, v of one new token at absolute position ``pos``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    return _qkv(params, x, cfg, positions)


def _decode_attend(params: dict, q: torch.Tensor, cfg: ArchConfig,
                   cache_k: torch.Tensor, cache_v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """One query token over every cache slot where ``mask`` (S,) holds;
    returns the output projection (B, 1, D)."""
    b = q.shape[0]
    kvh = cfg.n_kv_heads
    rep = cfg.n_heads // kvh
    qg = _scaled(q).to(DTYPE).reshape(b, 1, kvh, rep, cfg.d_head)
    logits = torch.einsum("bqgrd,bcgd->bgrqc", qg.float(),
                          cache_k.to(DTYPE).float())
    logits = _soft_cap(logits, cfg.logit_softcap)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(DTYPE)
    out = torch.einsum("bgrqc,bcgd->bqgrd", p.float(),
                       cache_v.to(DTYPE).float()).to(q.dtype)
    return out.reshape(b, 1, -1) @ params["wo"]


def decode_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, *, local: bool = False):
    """Single-token decode over a plain cache: x (B, 1, D); cache_k/v
    (B, S_max, KV, dh) updated IN PLACE at ``pos`` (the reference returned
    updated copies); ``local`` masks keys outside the sliding window.
    Returns (out (B, 1, D), cache_k, cache_v)."""
    q, k_new, v_new = _decode_qkv(params, x, cfg, pos)
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    k_pos = torch.arange(cache_k.shape[1], device=x.device)
    mask = k_pos <= pos
    if local:
        mask = mask & (k_pos > pos - cfg.sliding_window)
    return _decode_attend(params, q, cfg, cache_k, cache_v, mask), \
        cache_k, cache_v


def decode_attention_ring(params: dict, x: torch.Tensor, cfg: ArchConfig,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, slot: int):
    """Sliding-window decode over a ring-buffer cache of W slots, written
    IN PLACE at ``slot = pos % W``.  Keys are stored post-RoPE, so slot s
    holds absolute position ``pos - ((pos - s) mod W)``, always inside the
    window; only slots whose position is >= 0 are valid.  The cache costs
    O(W) instead of O(S_max).  Returns (out (B, 1, D), cache_k, cache_v)."""
    w = cache_k.shape[1]
    q, k_new, v_new = _decode_qkv(params, x, cfg, pos)
    cache_k[:, slot:slot + 1] = k_new.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v_new.to(cache_v.dtype)
    abs_pos = pos - (pos - torch.arange(w, device=x.device)) % w
    return _decode_attend(params, q, cfg, cache_k, cache_v, abs_pos >= 0), \
        cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP and embeddings.
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    op rounded to ``x``'s dtype as the reference's bf16 ``jax.nn.silu``
    rounds it (``F.silu`` rounds once, which moves 40% of bf16 outputs by
    an ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_block(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    up = x @ params["w_up"]
    if cfg.mlp_gated:
        up = silu(x @ params["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return up @ params["w_down"]


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]
    if isinstance(table, DTensor):
        # placed over a mesh: the embedding op, whose rules DTensor has in
        # every version (its index_put rule, indexing's backward, fails in
        # some); the same rows
        return F.embedding(tokens, table)
    return table[tokens]


#: Vocabulary columns per unembedding contraction: the float32 copy of
#: the weight is made one slice at a time (at gemma3's 262,144-token
#: vocabulary the whole copy would be 5.6 GB per call).
VOCAB_CHUNK = 16384


def unembed_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) bf16 -> (B, S, V) float32 logits, contracted in float32
    over ``VOCAB_CHUNK`` vocabulary columns at a time: each logit is the
    same sum over D, and the transient float32 weight is one slice."""
    w = params.get("unembed")
    if w is None:
        w = params["embed"].T
    xf = x.float()
    if isinstance(w, DTensor):
        # placed over a mesh: one contraction, the vocabulary sharded as
        # the weight is (a slice of a sharded column would gather it)
        return xf @ w.float()
    v = w.shape[1]
    out = torch.empty(x.shape[:-1] + (v,), dtype=torch.float32,
                      device=x.device)
    for lo in range(0, v, VOCAB_CHUNK):
        out[..., lo:lo + VOCAB_CHUNK] = xf @ w[:, lo:lo + VOCAB_CHUNK].float()
    return out


def _chunk_nll(params: dict, xc: torch.Tensor,
               lc: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk's labels >= 0."""
    logits = unembed_logits(params, xc)                     # (B, C, V)
    if isinstance(logits, DTensor):
        # DTensor's vocab-parallel gather (a masked partial) fails to
        # reduce a 3-D gather: the chunk's logits are gathered whole
        logits = sharding.replicate_dim(logits, -1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp_min(0)[..., None])[..., 0]
    return torch.where(lc >= 0, logz - gold, 0.0).sum()


def chunked_ce_loss(params: dict, x: torch.Tensor, labels: torch.Tensor, *,
                    chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the vocabulary of the labels >= 0 (-1 =
    masked), over ``chunk`` positions at a time so the (B, S, V) float32
    logits are never resident whole.  x: (B, S, D) bf16; labels (B, S).
    With grad enabled each chunk is rematerialised (``torch.utils.
    checkpoint``, as the reference's ``jax.checkpoint`` of its chunk
    body), so the backward pass holds one chunk's logits at a time."""
    s = x.shape[1]
    chunk = min(chunk, s)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, s, chunk):
        lc = labels[:, lo:lo + chunk]
        xc = x[:, lo:lo + chunk]
        if remat:
            nll = checkpoint(_chunk_nll, params, xc, lc, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            nll = _chunk_nll(params, xc, lc)
        total = total + nll
        count = count + (lc >= 0).sum()
    return total / count.clamp_min(1).float()
