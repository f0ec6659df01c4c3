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

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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

def _heads(t: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    """(B, S, n * d_head) as (B, S, n, d_head).  A placed projection
    whose split of the last dimension does not divide the ``n`` heads
    (4 KV heads over 16 processes) is gathered over those mesh
    dimensions first (the raw all-gather, ``sharding.redistribute``):
    DTensor cannot split fewer heads than processes."""
    b, s = t.shape[:2]
    if isinstance(t, DTensor):
        dm = t.device_mesh
        dims = [i for i, p in enumerate(t.placements) if p == Shard(2)]
        if n % math.prod(dm.size(i) for i in dims):
            t = sharding.replicate_dim(t, 2)
    return t.reshape(b, s, n, d_head)


def _qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    q = _heads(x @ params["wq"], cfg.n_heads, cfg.d_head)
    k = _heads(x @ params["wk"], cfg.n_kv_heads, cfg.d_head)
    v = _heads(x @ params["wv"], cfg.n_kv_heads, cfg.d_head)
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
    window.  GQA without repeating KV.  Returns (B, Sq, H, dh).  Placed
    over a mesh (``DTensor``), it runs on each process's blocks
    (:func:`_placed_attention`)."""
    if isinstance(q, DTensor):
        return _placed_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 kv_chunk=kv_chunk)
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


def _attention_layout(q: DTensor, kv_heads: int):
    """Per mesh dimension, the placements of q and of k/v for attention
    on local blocks, q's offset in the sequence, and the KV heads this
    process's query heads read: batch rows stay split; query heads stay
    split, with their KV heads split alike where those divide, else each
    process takes the KV heads of its own query heads (where its heads
    cover whole groups, or lie in one); a split query sequence keeps its
    rows against all keys; anything else is replicated."""
    dm = q.device_mesh
    coord = dm.get_coordinate()
    n_heads = q.shape[2]
    q_pl, kv_pl, offset, kv_range = [], [], 0, None
    for i, p in enumerate(q.placements):
        n = dm.size(i)
        local = n_heads // n
        rep = n_heads // kv_heads
        if p == Shard(0):
            q_pl.append(p)
            kv_pl.append(p)
        elif p == Shard(2) and kv_heads % n == 0:
            q_pl.append(p)
            kv_pl.append(p)
        elif p == Shard(2) and n_heads % n == 0 and kv_range is None \
                and (local % rep == 0 or rep % local == 0):
            q_pl.append(p)
            kv_pl.append(Replicate())
            kv_range = (coord[i] * local // rep,
                        ((coord[i] + 1) * local - 1) // rep + 1)
        elif p == Shard(1) and q.shape[1] % n == 0:
            q_pl.append(p)
            kv_pl.append(Replicate())
            offset += coord[i] * (q.shape[1] // n)
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    return q_pl, kv_pl, offset, kv_range


def _placed_attention(q, k, v, *, causal, window, softcap, q_offset,
                      kv_chunk):
    """:func:`chunked_attention` of placed tensors on each process's
    blocks (:func:`_attention_layout`): every output block is the plain
    function of its rows, heads and keys, in the same float32 order as on
    one process, and no collective runs unless a layout must change (a
    split query sequence gathers its keys, query heads split finer than
    the KV heads gather those).  DTensor's own rules for the
    grouped-query contractions differ between versions."""
    q_pl, kv_pl, offset, kv_range = _attention_layout(q, k.shape[2])

    def attend(ql, kl, vl):
        if kv_range is not None:
            kl = kl[:, :, kv_range[0]:kv_range[1]]
            vl = vl[:, :, kv_range[0]:kv_range[1]]
        return chunked_attention(ql, kl, vl, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset + offset,
                                 kv_chunk=kv_chunk)

    return sharding.local_map(attend, (q, k, v), (q_pl, kv_pl, kv_pl),
                              (q_pl,))


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
    return _seq_shard(out_proj(out, params["wo"]), cfg)


def out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention output (B, S, H, dh) through ``wo`` (H * dh, D), a
    row-parallel product on placed operands (:func:`row_parallel`, the
    heads and head dimension folded into the contraction on each
    process's blocks: DTensor refuses, on some versions, to fold a split
    sequence into the product's rows)."""
    if isinstance(out, DTensor):
        return row_parallel(out, wo, cdim=2)
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ wo


def row_parallel(x: torch.Tensor, w: torch.Tensor, cdim: int = -1):
    """``x @ w`` for a row-parallel weight (``wo``, ``w_down``: rows split
    over ``model`` by ``param_specs``), ``x``'s dimensions from ``cdim``
    on folded into the contraction.  Placed, it runs on each process's
    blocks (``sharding.local_map``), per mesh dimension: where ``x``
    splits its rows (the batch, a split sequence) they stay split and
    ``w`` is taken whole there; else where ``w`` splits its rows and
    ``x``'s dimension ``cdim`` splits as evenly (4 KV-sized heads do not
    over 16), ``x`` takes the matching columns and the output is that
    dimension's ``Partial`` sum (reduced by the caller); anything else
    is whole.
    Backward is two local products (``local_map`` states the gradients'
    placements): no weight moves but where it was taken whole.  Plain
    tensors: ``x @ w`` after the fold."""
    cdim %= x.dim()

    def fold(xl, wl):
        return xl.reshape(xl.shape[:cdim] + (-1,)) @ wl

    if not isinstance(x, DTensor):
        return fold(x, w)
    dm, ways = x.device_mesh, 1
    x_pl, w_pl, out_pl = [], [], []
    for i, (p, q) in enumerate(zip(x.placements, w.placements)):
        if isinstance(p, Shard) and p.dim < cdim:
            x_pl.append(p)
            w_pl.append(Replicate())
            out_pl.append(p)
        elif q == Shard(0) and x.shape[cdim] % (ways * dm.size(i)) == 0:
            ways *= dm.size(i)
            x_pl.append(Shard(cdim))
            w_pl.append(q)
            out_pl.append(Partial())
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            out_pl.append(Replicate())
    return sharding.local_map(fold, (x, w), (x_pl, w_pl), out_pl)


def _decode_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig, pos: int):
    """q, k, v of one new token at absolute position ``pos``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    return _qkv(params, x, cfg, positions)


def _decode_attend(params: dict, q: torch.Tensor, cfg: ArchConfig,
                   cache_k: torch.Tensor, cache_v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """One query token over every cache slot where ``mask`` (S,) holds;
    returns the output projection (B, 1, D).  A placed cache is attended
    on each process's blocks (:func:`_placed_decode_attend`)."""
    if isinstance(cache_k, DTensor):
        out = _placed_decode_attend(q, cfg, cache_k, cache_v, mask)
    else:
        out = _attend_one(q, cfg, cache_k, cache_v, mask)
    b = q.shape[0]
    return out.reshape(b, 1, -1) @ params["wo"]


def _attend_one(q, cfg: ArchConfig, cache_k, cache_v, mask, group=None):
    """The attention of one query token (B, 1, H, dh) over its cache
    slots; with ``group``, the slots are this process's block of a cache
    whose sequence is split over ``group``, and the softmax's max and sum
    and the output are reduced over it (split-KV decoding)."""
    b, _, h, dh = q.shape
    kvh = cache_k.shape[2]
    qg = _scaled(q).to(DTYPE).reshape(b, 1, kvh, h // kvh, dh)
    logits = torch.einsum("bqgrd,bcgd->bgrqc", qg.float(),
                          cache_k.to(DTYPE).float())
    logits = _soft_cap(logits, cfg.logit_softcap)
    logits = torch.where(mask, logits, NEG_INF)
    if group is None:
        p = torch.softmax(logits, dim=-1).to(DTYPE)
        out = torch.einsum("bgrqc,bcgd->bqgrd", p.float(),
                           cache_v.to(DTYPE).float())
        return out.to(q.dtype)
    from torch.distributed import _functional_collectives as funcol
    m = funcol.all_reduce(logits.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(logits - m)
    total = funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
    p = (e / total).to(DTYPE)
    out = torch.einsum("bgrqc,bcgd->bqgrd", p.float(),
                       cache_v.to(DTYPE).float())
    return funcol.all_reduce(out, "sum", group).to(q.dtype)


def _placed_decode_attend(q, cfg: ArchConfig, cache_k: DTensor,
                          cache_v: DTensor, mask: torch.Tensor):
    """:func:`_attend_one` over a placed cache: batch rows and KV heads
    as the cache splits them (the query follows), and where the cache
    splits its sequence (``cache_specs(seq_shard=True)``) each process
    attends its own slots and the softmax is reduced over that mesh
    dimension."""
    dm = cache_k.device_mesh
    off, size = sharding.block_bounds(cache_k.shape, cache_k.placements, dm)
    q_pl, group = [], None
    for i, p in enumerate(cache_k.placements):
        if p == Shard(1):
            if group is not None:
                raise ValueError("the cache's sequence is split over more "
                                 "than one mesh dimension")
            group = dm.get_group(i)
            q_pl.append(Replicate())
        else:
            q_pl.append(p if p in (Shard(0), Shard(2)) else Replicate())
    local_mask = mask[off[1]:off[1] + size[1]]

    def attend(ql, kl, vl):
        return _attend_one(ql, cfg, kl, vl, local_mask, group)

    return sharding.local_map(attend, (q, cache_k, cache_v),
                              (q_pl, cache_k.placements, cache_v.placements),
                              (q_pl,))


def write_slots(cache: torch.Tensor, slots, values: torch.Tensor) -> None:
    """``cache[:, slots[j]] = values[:, j]`` IN PLACE for the host list
    ``slots`` of sequence positions.  A placed cache writes on each
    process only the slots of its own block (the values are brought to
    the cache's placements, their sequence whole), as runs of slices."""
    if not isinstance(cache, DTensor):
        cache[:, slots] = values.to(cache.dtype)
        return
    dm = cache.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, dm, [Replicate()] * dm.ndim,
                                    run_check=False)
    vals = sharding.redistribute(values, pl).to_local()
    off, size = sharding.block_bounds(cache.shape, cache.placements, dm)
    lo, hi = off[1], off[1] + size[1]
    runs = []                                # [block slot, value index, n]
    for j, slot in enumerate(slots):
        if not lo <= slot < hi:
            continue
        if runs and runs[-1][0] + runs[-1][2] == slot - lo \
                and runs[-1][1] + runs[-1][2] == j:
            runs[-1][2] += 1
        else:
            runs.append([slot - lo, j, 1])
    block = cache.to_local()
    for dst, src, n in runs:
        block[:, dst:dst + n] = vals[:, src:src + n].to(block.dtype)


def decode_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, *, local: bool = False):
    """Single-token decode over a plain cache: x (B, 1, D); cache_k/v
    (B, S_max, KV, dh) updated IN PLACE at ``pos`` (the reference returned
    updated copies); ``local`` masks keys outside the sliding window.
    Returns (out (B, 1, D), cache_k, cache_v)."""
    q, k_new, v_new = _decode_qkv(params, x, cfg, pos)
    if isinstance(cache_k, DTensor):
        write_slots(cache_k, [pos], k_new)
        write_slots(cache_v, [pos], v_new)
    else:
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
    if isinstance(cache_k, DTensor):
        write_slots(cache_k, [slot], k_new)
        write_slots(cache_v, [slot], v_new)
    else:
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
    return row_parallel(up, params["w_down"])


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]
    if isinstance(table, DTensor):
        # placed over a mesh: each process's block of vocabulary rows,
        # summed (DTensor's own rules for indexing and for the embedding
        # op fail on some versions); the same rows
        return sharding.vocab_rows(table, tokens)
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
