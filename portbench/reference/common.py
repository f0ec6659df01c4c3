"""Plain float32 pieces the architecture references share.

Nothing here imports the program.  Every product runs in float32 with
TF32 off (:func:`float32_matmuls`), from the served weights upcast.
``precision="fp8"`` is the control: each product's operands rounded to
float8 e4m3 (the activation per row, the weight per output column, each
scaled to its largest magnitude) before the float32 product, as a
serving stack that stores and multiplies in fp8 would.
"""
from __future__ import annotations

import contextlib
import math

import torch

F32 = torch.float32
FP8_MAX = 448.0          # largest finite float8 e4m3 value


@contextlib.contextmanager
def float32_matmuls():
    """Products in true float32 (TF32 off) for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32: x (..., K), w (K, N) as served."""
    w = w.to(F32)
    x = x.to(F32)
    if precision == "fp8":
        x = fp8_round(x, -1)
        w = fp8_round(w, 0)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm scaled by ``1 + w`` (the program's parameterisation:
    a weight of zero is the identity scale)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.to(F32))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (R, S, H, dh) at positions 0..S-1, the
    halves rotated as a pair (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1
    sin), angles in float64."""
    s, dh = x.shape[1], x.shape[-1]
    inv = theta ** -(torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(F32)[None, :, None, :]
    sin = torch.sin(ang).to(F32)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, head_block: int = 8) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh), causal) v for one row: q (S, H, dh),
    k and v (S, KV, dh), query head h reading KV head h // (H / KV).
    Returns (S, H * dh).  Heads go ``head_block`` at a time."""
    s, h, dh = q.shape
    rep = h // k.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(s, h, dh, dtype=F32, device=q.device)
    for lo in range(0, h, head_block):
        hs = range(lo, min(lo + head_block, h))
        qh = q[:, lo:lo + len(hs)].transpose(0, 1)              # (h, S, dh)
        kh = k[:, [j // rep for j in hs]].transpose(0, 1)
        vh = v[:, [j // rep for j in hs]].transpose(0, 1)
        sc = (qh @ kh.transpose(1, 2)) / math.sqrt(dh)
        sc = sc.masked_fill(~mask, -math.inf)
        out[:, lo:lo + len(hs)] = (torch.softmax(sc, -1) @ vh).transpose(0, 1)
    return out.reshape(s, h * dh)


def attention_block(p: dict, x: torch.Tensor, m: dict, eps: float,
                    precision: str) -> torch.Tensor:
    """x + attention(norm(x)), then + the gated MLP of norm: a
    pre-norm block with weights ``p`` (``ln1``, ``attn``, ``ln2``,
    ``mlp``) over x (R, S, D)."""
    r, s, _ = x.shape
    h, kv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    a = p["attn"]
    hn = rms_norm(x, p["ln1"], eps)
    q = rope(mm(hn, a["wq"], precision).view(r, s, h, dh), m["rope_theta"])
    k = rope(mm(hn, a["wk"], precision).view(r, s, kv, dh), m["rope_theta"])
    v = mm(hn, a["wv"], precision).view(r, s, kv, dh)
    o = torch.stack([causal_attention(q[i], k[i], v[i]) for i in range(r)])
    x = x + mm(o, a["wo"], precision)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], eps), precision)


def mlp(p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """silu(x W_gate) * (x W_up), through W_down."""
    return mm(silu(mm(x, p["w_gate"], precision)) * mm(x, p["w_up"],
                                                       precision),
              p["w_down"], precision)


def embed(weights: dict, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """Token embeddings scaled by sqrt(d_model), float32."""
    return weights["embed"]["embed"][tokens].to(F32) * math.sqrt(d_model)


def head(weights: dict, x: torch.Tensor, eps: float,
         precision: str) -> torch.Tensor:
    """Final norm and unembedding: (R, n, D) -> (R, n, V) logits."""
    return mm(rms_norm(x, weights["final_ln"], eps),
              weights["embed"]["unembed"], precision)


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree of stacked leaves (the group axis first)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
