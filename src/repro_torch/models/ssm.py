"""State-space blocks: Mamba-1 (selective scan) and Mamba-2 (SSD, chunked)
— port of ``repro/models/ssm.py``.  Plain functions over parameter dicts
of tensors, in the style of ``models/moe.py``.

Both blocks run chunk by chunk over the sequence, so the discretized
(B, L, d_inner, N) tensors exist one chunk at a time.  The reference's
``lax.scan`` over chunks is a Python loop, and so is Mamba-1's scan over
the steps inside a chunk: one ``addcmul`` launch a step, ``h = dBx + h *
dA`` out of place (autograd saves each ``h``), the chunk's states then
stacked for the output contraction.  Mamba-1 skips the padded steps of a
last partial chunk: they have ``dt = 0``, so ``dA = 1`` and
``dBx = 0`` and they would leave the state exactly as it is.  Mamba-2
pads as the reference does (its chunk is one set of contractions).

Numerics follow the reference's rounding points: the recurrent state is
float32, the conv tail bf16; the block's conv output is rounded to bf16
before its ``silu`` (rounded per op as ``jax.nn.silu`` is on bf16), the
decode step's is not (float32 ``silu``, rounded after).  Inside a layer
group the reference runs the block in a compiled scan body, where XLA
keeps some values at float32 that op by op are bf16: Mamba-2's gated norm
reads the unrounded product ``y_bf16 * silu(z)_bf16`` (block and decode
step), and Mamba-1's skip term the unrounded ``silu`` product when no
padding slices it.  ``fused=True`` follows that body (the stack passes it
for its grouped blocks); the default follows the op-by-op reference, as
its remainder blocks and direct calls run.
Decode updates the state and the conv buffer IN PLACE (the reference
returned updated copies), as ``layers.decode_attention`` does its cache.

Placed over a mesh (``DTensor`` weights by ``param_specs``: every
projection, ``conv_w`` and Mamba-1's ``a_log`` split by their last
dimension over ``model``), the blocks run as DTensor ops, each gather
taken by ``sharding``'s raw all-gather before the op that needs it; the
decode step runs on each process's blocks (:func:`_decode_on_rows`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
from repro_torch.models import layers

DTYPE = layers.DTYPE
F32 = torch.float32


# ---------------------------------------------------------------------------
# Shapes and init.
# ---------------------------------------------------------------------------

def dt_rank(cfg: ArchConfig) -> int:
    return max(cfg.d_model // 16, 1)


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def m2_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def mamba1_shapes(cfg: ArchConfig, lead: tuple = ()) -> dict:
    """``(shape, dtype)`` of each leaf of a Mamba-1 block's ``ssm``
    subtree (``lead`` prefixes every shape: a stacked block's group
    axis)."""
    di, n, r = d_inner(cfg), cfg.ssm_state, dt_rank(cfg)
    d, k = cfg.d_model, cfg.ssm_conv
    return {"wx": (lead + (d, di), DTYPE), "wz": (lead + (d, di), DTYPE),
            "conv_w": (lead + (k, di), DTYPE), "conv_b": (lead + (di,), DTYPE),
            "x_proj": (lead + (di, r + 2 * n), DTYPE),
            "dt_w": (lead + (r, di), DTYPE), "dt_b": (lead + (di,), DTYPE),
            "a_log": (lead + (di, n), F32), "d_skip": (lead + (di,), F32),
            "out_proj": (lead + (di, d), DTYPE)}


def mamba2_shapes(cfg: ArchConfig, lead: tuple = ()) -> dict:
    """``(shape, dtype)`` of each leaf of a Mamba-2 block's ``ssm``
    subtree."""
    di, n, h = d_inner(cfg), cfg.ssm_state, m2_heads(cfg)
    d, k = cfg.d_model, cfg.ssm_conv
    return {"wz": (lead + (d, di), DTYPE),
            "wxbc": (lead + (d, di + 2 * n), DTYPE),
            "wdt": (lead + (d, h), DTYPE),
            "conv_w": (lead + (k, di + 2 * n), DTYPE),
            "conv_b": (lead + (di + 2 * n,), DTYPE),
            "a_log": (lead + (h,), F32), "dt_b": (lead + (h,), F32),
            "d_skip": (lead + (h,), F32), "norm_w": (lead + (di,), DTYPE),
            "out_proj": (lead + (di, d), DTYPE)}


#: Random leaves drawn at a fixed scale instead of ``fan_in ** -0.5``.
_SCALES = {"conv_w": 0.5, "wdt": 0.02}


def init_leaf(gen: torch.Generator, name: str, shape: tuple, dtype,
              device=None) -> torch.Tensor:
    """One layer's leaf ``name`` of an ``ssm`` subtree, as the reference
    makes it: the deterministic leaves (``a_log`` S4D-real for Mamba-1,
    ``log(linspace(1, 16, H))`` for Mamba-2; ``dt_b = log(expm1(0.01))``;
    ``d_skip = 1``; ``conv_b`` and ``norm_w`` zero), and the others drawn
    from ``gen`` by ``layers.dense_init``.  ``a_log`` is rounded to
    float32 from float64 on the host, so it is the same on every device
    (XLA's float32 ``log`` on the CPU is an ulp off at some points)."""
    device = device or gen.device
    if name == "a_log":
        if len(shape) == 2:                  # Mamba-1: (d_inner, N)
            a = np.tile(np.arange(1, shape[1] + 1, dtype=np.float64),
                        (shape[0], 1))
        else:                                # Mamba-2: (H,)
            a = np.linspace(1.0, 16.0, shape[0])
        return torch.from_numpy(np.log(a).astype(np.float32)).to(device)
    if name == "dt_b":
        v = torch.log(torch.expm1(torch.full(shape, 0.01, dtype=F32)))
        return v.to(device=device, dtype=dtype)
    if name == "d_skip":
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ("conv_b", "norm_w"):
        return torch.zeros(shape, dtype=dtype, device=device)
    return layers.dense_init(gen, shape, scale=_SCALES.get(name),
                             dtype=dtype, device=device)


def init_mamba1(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {k: init_leaf(gen, k, *v) for k, v in mamba1_shapes(cfg).items()}


def init_mamba2(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {k: init_leaf(gen, k, *v) for k, v in mamba2_shapes(cfg).items()}


# ---------------------------------------------------------------------------
# Shared pieces.
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) — causal per-channel conv, the taps added
    in order in float32, rounded to ``x``'s dtype once."""
    k, s = w.shape[0], x.shape[1]
    # zeros cat before the sequence, not F.pad: a placed (DTensor) x keeps
    # its placements, where DTensor's pad rule fails on some versions
    zero = torch.zeros_like(x[:, :1]).expand(-1, k - 1, -1)
    xp = torch.cat([zero, x], dim=1)
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k):
        acc = acc + xp[:, i:i + s].float() * wf[i]
    return (acc + b.float()).to(x.dtype)


def _conv_tail(x_raw: torch.Tensor, k: int) -> torch.Tensor:
    """The last K-1 raw conv inputs (zeros before the sequence), bf16:
    the decode step's conv buffer after a prefill of ``x_raw``."""
    s = x_raw.shape[1]
    # a zeros cat, not F.pad, as in the causal conv (placed tensors)
    zero = torch.zeros_like(x_raw[:, :1]).expand(-1, k - 1, -1)
    return torch.cat([zero, x_raw], dim=1)[:, s:s + k - 1].to(DTYPE)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 (B, K) and (K, N) with the float32 result left
    unrounded, as XLA's CPU dot of a decode step's 2-D operands leaves it
    where the reference casts the product to float32.  On the card
    cuBLAS writes the float32 product directly; the CPU has no such GEMM,
    so there the operands are widened first (the same products)."""
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=F32)
    return x.float() @ w.float()


def _conv_out(x_t: torch.Tensor, conv_buf: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """The float32 output (B, C) of one causal conv step over channels
    [lo, lo + C) of the (B, K-1, C_all) tap buffer: ``x_t`` (B, C) and
    ``w`` (K, C) hold those channels, ``b`` all of them."""
    hi = lo + x_t.shape[-1]
    ext = torch.cat([conv_buf[..., lo:hi],
                     x_t[:, None, :].to(conv_buf.dtype)], dim=1)
    return torch.einsum("bkc,kc->bc", ext.float(), w.float()) \
        + b[lo:hi].float()


def _conv_shift(x_t: torch.Tensor, conv_buf: torch.Tensor) -> None:
    """The tap buffer shifted by one IN PLACE, ``x_t`` (B, C) last."""
    conv_buf.copy_(torch.cat([conv_buf[:, 1:],
                              x_t[:, None, :].to(conv_buf.dtype)], dim=1))


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b: d_state 16, expand 2, conv 4, dt_rank D/16).
# ---------------------------------------------------------------------------

def _selective_scan(dt, xh, b_in, c_in, a, chunk: int):
    """``h_t = h_{t-1} * exp(dt_t a) + dt_t x_t b_t``, ``y_t = h_t c_t``
    over S steps from ``h_0 = 0``, chunk by chunk.  dt: (B, S, di)
    float32; xh, b_in, c_in: (B, S, di | N) bf16; a: (di, N).  Returns
    (y (B, S, di) float32, h_final (B, di, N) float32)."""
    b, s, di = dt.shape
    n = a.shape[1]
    h = torch.zeros((b, di, n), dtype=F32, device=dt.device)
    y = torch.empty((b, s, di), dtype=F32, device=dt.device)
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        dtc = dt[:, lo:hi].transpose(0, 1)                  # (L, B, di)
        da = torch.exp(dtc[..., None] * a)                  # (L, B, di, N)
        xc = xh[:, lo:hi].transpose(0, 1).float()
        bc = b_in[:, lo:hi].transpose(0, 1).float()
        dbx = (dtc * xc)[..., None] * bc[:, :, None, :]
        hs = []
        # out of place: autograd saves h; unbind splits each chunk once
        # (one view op, and one stack in the backward pass, where
        # indexing would add a select and its backward per step)
        for dbx_t, da_t in zip(dbx.unbind(0), da.unbind(0)):
            h = torch.addcmul(dbx_t, h, da_t)
            hs.append(h)
        cc = c_in[:, lo:hi].transpose(0, 1).float()
        y[:, lo:hi] = torch.einsum("lbdn,lbn->bld", torch.stack(hs), cc)
    return y, h


def mamba1_block(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                 chunk: int = 64, return_state: bool = False,
                 fused: bool = False):
    """x: (B, S, D) bf16 -> (B, S, D) via the chunked selective scan.
    With ``return_state``: also returns (h_final (B, di, N) float32, conv
    tail (B, K-1, di) bf16) to seed decode.  ``fused`` rounds as the
    reference's compiled layer-group body does (module docstring)."""
    r, n = dt_rank(cfg), cfg.ssm_state
    chunk = min(chunk, x.shape[1])
    # placed, each activation split by columns is gathered whole where
    # it is made (the raw all-gather; on one process a no-op)
    xh_raw = x @ params["wx"]
    z = _whole(x @ params["wz"])
    conv = _causal_depthwise_conv(xh_raw, params["conv_w"], params["conv_b"])
    xh32 = _whole(conv.float() * (1 / (1 + torch.exp(-conv))).float())
    xh = xh32.to(DTYPE)                  # == layers.silu(conv)
    dbc = _whole(xh @ params["x_proj"])
    dt_in, b_in, c_in = torch.split(dbc, [r, n, n], dim=-1)
    dt = softplus(_whole(dt_in @ params["dt_w"]).float()
                  + params["dt_b"].float())
    a = -torch.exp(params["a_log"])
    # placed over a mesh, the scan runs on each process's own batch rows
    # with ``a`` whole (its in-place output and per-step states have no
    # DTensor form)
    rows = (sharding.row_placements(dt) if isinstance(dt, DTensor)
            else None)
    whole = None if rows is None else [Replicate()] * len(rows)
    y, h_final = sharding.local_map(
        lambda *t: _selective_scan(*t, chunk), (dt, xh, b_in, c_in, a),
        [rows] * 4 + [whole], rows)
    # compiled, XLA reads the unrounded silu product here unless padding
    # sliced it; op by op it reads the bf16 xh
    unrounded = fused and x.shape[1] % chunk == 0
    y = y + (xh32 if unrounded else xh.float()) * params["d_skip"]
    y = (y * layers.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"]
    if return_state:
        return out, h_final, _conv_tail(xh_raw, cfg.ssm_conv)
    return out


def mamba1_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                  h: torch.Tensor, conv_buf: torch.Tensor, *,
                  fused: bool = False):
    """One token.  x: (B, 1, D); h: (B, di, N) float32; conv_buf: (B, K-1,
    di) bf16 — both updated IN PLACE.  Returns (out (B, 1, D), h,
    conv_buf); ``fused`` as for :func:`mamba1_block`.  A placed state is
    stepped on each process's rows (:func:`_decode_on_rows`)."""
    if isinstance(h, DTensor):
        return _decode_on_rows(_mamba1_step, params, x, cfg, h, conv_buf,
                               fused)
    return _mamba1_step(_Blocks(params), x, cfg, h, conv_buf, fused), h, \
        conv_buf


def _mamba1_step(p: "_Blocks", x, cfg: ArchConfig, h, conv_buf,
                 fused: bool) -> torch.Tensor:
    """:func:`mamba1_decode` on plain tensors, its weights ``p`` whole
    or this process's column blocks (:class:`_Blocks`); returns the
    output (B, 1, D)."""
    r, n = dt_rank(cfg), cfg.ssm_state
    mm = _mm_f32 if fused else torch.mm
    xh_raw = x[:, 0] @ p["wx"]
    z = mm(x[:, 0], p["wz"])
    xh = layers.silu(_conv_out(xh_raw, conv_buf, p["conv_w"], p["conv_b"],
                               p.lo("wx"))).to(x.dtype)
    xh_raw, xh, z = p.whole((xh_raw, "wx"), (xh, "wx"), (z, "wz"))
    _conv_shift(xh_raw, conv_buf)
    dbc, = p.whole((xh @ p["x_proj"], "x_proj"))
    dt_in, b_in, c_in = torch.split(dbc, [r, n, n], dim=-1)
    dt_mm, = p.whole((mm(dt_in, p["dt_w"]), "dt_w"))
    dt = softplus(dt_mm.float() + p["dt_b"].float())
    a = -torch.exp(p.leaf("a_log"))
    da = torch.exp(dt[..., None] * a)                        # (B, di, N)
    dbx = (dt * xh.float())[..., None] * b_in.float()[:, None, :]
    torch.addcmul(dbx, h, da, out=h)
    y = torch.einsum("bdn,bn->bd", h, c_in.float())
    y = y + xh.float() * p["d_skip"]
    y = (y * layers.silu(z.float())).to(x.dtype)
    out, = p.whole((y @ p["out_proj"], "out_proj"))
    return out[:, None, :]


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2: d_state 64, head_dim 64, scalar A per head).
# ---------------------------------------------------------------------------

def _gated_norm(y: torch.Tensor, z: torch.Tensor, norm_w: torch.Tensor,
                fused: bool) -> torch.Tensor:
    """``rms_norm(y_bf16 * silu(z_f32)_bf16)`` (B, S, di) bf16.  The
    product is rounded to bf16 op by op; ``fused``, the norm reads it
    unrounded, as XLA computes it inside a compiled body."""
    g = y.to(DTYPE).float() * layers.silu(z.float()).to(DTYPE).float()
    if not fused:
        g = g.to(DTYPE)
    return layers.rms_norm(g, norm_w).to(DTYPE)


def _ssd_chunks(xhh, dtc, la, bb, cc):
    """The SSD scan chunk by chunk from a zero state: the intra-chunk
    (diagonal) and carried-state terms of y (B, C, L, H, P) float32, the
    skip term not added, and the final state (B, H, P, N).  xhh: (B, C, L,
    H, P); dtc, la: (B, C, L, H); bb, cc: (B, C, L, N) float32."""
    bsz, n_chunks, chunk, h, p = xhh.shape
    n = bb.shape[-1]
    iota = torch.arange(chunk, device=xhh.device)
    causal = (iota[:, None] >= iota[None, :])[None, :, :, None]
    hstate = torch.zeros((bsz, h, p, n), dtype=F32, device=xhh.device)
    ys = torch.empty((bsz, n_chunks, chunk, h, p), dtype=F32,
                     device=xhh.device)
    for ci in range(n_chunks):
        xc = xhh[:, ci].float()                                  # (B,L,H,P)
        d, bc, ccc = dtc[:, ci], bb[:, ci], cc[:, ci]
        cs = torch.cumsum(la[:, ci], dim=1)                      # (B,L,H)
        # intra-chunk term; exp(cs_i - cs_j) overflows above the
        # diagonal, so the exponent is masked to -inf before the exp: the
        # same values as masking exp's output, and a finite gradient
        # (masking after the exp leaves 0 * inf = NaN in the backward
        # pass once a chunk's decay passes e^88, as the reference's does)
        seg = cs[:, :, None, :] - cs[:, None, :, :]              # (B,L,L,H)
        decay = torch.exp(torch.where(causal, seg, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", ccc, bc)
        w = cb[..., None] * decay
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xc * d[..., None])
        # inter-chunk term: the carried state, decayed
        y_off = torch.einsum("bln,bhpn,blh->blhp", ccc, hstate,
                             torch.exp(cs))
        ys[:, ci] = y_diag + y_off
        tail = torch.exp(cs[:, -1:, :] - cs)                     # to the end
        new_state = hstate * torch.exp(cs[:, -1])[..., None, None]
        hstate = new_state + torch.einsum("blh,bln,blhp->bhpn", tail * d,
                                          bc, xc)
    return ys, hstate


def mamba2_block(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                 chunk: int = 256, return_state: bool = False,
                 fused: bool = False):
    """SSD forward, chunked (Mamba-2 minimal algorithm).  x: (B, S, D).
    With ``return_state``: also returns (h_final (B, H, P, N) float32,
    conv tail (B, K-1, di + 2N) bf16).  ``fused`` as for
    :func:`mamba1_block`."""
    bsz, s, _ = x.shape
    di, n, h = d_inner(cfg), cfg.ssm_state, m2_heads(cfg)
    p = cfg.ssm_head_dim
    # placed, each activation split by columns is gathered whole where
    # it is made (the raw all-gather; on one process a no-op)
    z = _whole(x @ params["wz"])
    xbc_raw = x @ params["wxbc"]
    dt_in = _whole(x @ params["wdt"])
    xbc = _whole(layers.silu(_causal_depthwise_conv(
        xbc_raw, params["conv_w"], params["conv_b"])))
    xh, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt_in.float() + params["dt_b"])                # (B, S, H)
    a = -torch.exp(params["a_log"])                              # (H,)
    log_a = dt * a                                               # <= 0

    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:                     # padded steps: dt = 0, x = 0 (no effect)
        xh, dt, log_a, b_in, c_in = (F.pad(t, (0, 0, 0, pad)) for t in
                                     (xh, dt, log_a, b_in, c_in))
    xhh = xh.reshape(bsz, n_chunks, chunk, h, p)
    dtc = dt.reshape(bsz, n_chunks, chunk, h)
    la = log_a.reshape(bsz, n_chunks, chunk, h)
    bb = b_in.reshape(bsz, n_chunks, chunk, n).float()
    cc = c_in.reshape(bsz, n_chunks, chunk, n).float()
    # placed over a mesh, the chunk loop runs on each process's own batch
    # rows (its rows are independent): DTensor has no sharding rule for
    # aten.flip, cumsum's backward, in some versions
    ys, hstate = sharding.local_rows(_ssd_chunks, xhh, dtc, la, bb, cc)
    d_skip = params["d_skip"][None, None, None, :, None]
    y = (ys + xhh.float() * d_skip).reshape(bsz, n_chunks * chunk, di)
    y = y[:, :s]
    out = _gated_norm(y, z, params["norm_w"], fused) @ params["out_proj"]
    if return_state:
        return out, hstate, _conv_tail(xbc_raw, cfg.ssm_conv)
    return out


def mamba2_decode(params: dict, x: torch.Tensor, cfg: ArchConfig,
                  hstate: torch.Tensor, conv_buf: torch.Tensor, *,
                  fused: bool = False):
    """One SSD token.  x: (B, 1, D); hstate: (B, H, P, N) float32;
    conv_buf: (B, K-1, di + 2N) bf16 — both updated IN PLACE.  Returns
    (out (B, 1, D), hstate, conv_buf); ``fused`` as for
    :func:`mamba1_block`.  A placed state is stepped on each process's
    rows (:func:`_decode_on_rows`)."""
    if isinstance(hstate, DTensor):
        return _decode_on_rows(_mamba2_step, params, x, cfg, hstate,
                               conv_buf, fused)
    return _mamba2_step(_Blocks(params), x, cfg, hstate, conv_buf, fused), \
        hstate, conv_buf


def _mamba2_step(p: "_Blocks", x, cfg: ArchConfig, hstate, conv_buf,
                 fused: bool) -> torch.Tensor:
    """:func:`mamba2_decode` on plain tensors, its weights ``p`` whole
    or this process's column blocks (:class:`_Blocks`); returns the
    output (B, 1, D)."""
    bsz = x.shape[0]
    di, n, h = d_inner(cfg), cfg.ssm_state, m2_heads(cfg)
    hd = cfg.ssm_head_dim
    mm = _mm_f32 if fused else torch.mm
    z = mm(x[:, 0], p["wz"])
    xbc_raw = x[:, 0] @ p["wxbc"]
    dt_in = mm(x[:, 0], p["wdt"])
    xbc = layers.silu(_conv_out(xbc_raw, conv_buf, p["conv_w"], p["conv_b"],
                                p.lo("wxbc"))).to(x.dtype)
    z, xbc_raw, dt_in, xbc = p.whole((z, "wz"), (xbc_raw, "wxbc"),
                                     (dt_in, "wdt"), (xbc, "wxbc"))
    _conv_shift(xbc_raw, conv_buf)
    xh, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt_in.float() + p["dt_b"])                     # (B, H)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)
    xhp = xh.reshape(bsz, h, hd).float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xhp, b_in.float())
    torch.addcmul(upd, hstate, da[:, :, None, None], out=hstate)
    y = torch.einsum("bhpn,bn->bhp", hstate, c_in.float())
    y = (y + xhp * p["d_skip"][None, :, None]).reshape(bsz, 1, di)
    out, = p.whole((_gated_norm(y, z[:, None, :], p["norm_w"], fused)
                    @ p["out_proj"], "out_proj"))
    return out


def _whole(t):
    """A placed activation with its last dimension gathered whole over
    the mesh dimensions that split it (``sharding.replicate_dim``, the
    raw all-gather); a plain tensor as it is."""
    return sharding.replicate_dim(t, -1) if isinstance(t, DTensor) else t


#: Mamba-1's ``a_log`` (di, N) gathered whole, once per placed block:
#: its last dimension is split like a projection's, and every process
#: updates the whole state.  Keyed by the block's place in its storage,
#: which is held weakly (an entry whose storage is freed is dropped), and
#: taken again once the block is written in place (its version counter
#: moves).
_WHOLE_LEAVES: dict = {}


class _Blocks:
    """A decode step's weights as this process's blocks: ``self[name]``
    a weight's local block, :meth:`lo` the first of the columns of its
    last dimension that it holds, and :meth:`whole` the activations
    computed on such columns, gathered whole (``sharding.gather_columns``:
    one raw all-gather per set of mesh dimensions and dtype).  Over plain
    tensors every block is whole and nothing moves."""

    def __init__(self, params: dict, device_mesh=None):
        self.params, self.dm = params, device_mesh
        self.split = {}                  # name -> (lo, mesh dims)
        for name, w in params.items():
            if not isinstance(w, DTensor):
                continue
            last = Shard(w.dim() - 1)
            if any(not isinstance(q, Replicate) and q != last
                   for q in w.placements):
                raise ValueError(f"SSM weight {name} placed "
                                 f"{list(w.placements)}: only its last "
                                 "dimension may be split")
            off, _ = sharding.block_bounds(w.shape, w.placements, self.dm)
            self.split[name] = (off[-1], tuple(
                i for i, q in enumerate(w.placements) if q == last))

    def __getitem__(self, name: str) -> torch.Tensor:
        w = self.params[name]
        return w.to_local() if isinstance(w, DTensor) else w

    def lo(self, name: str) -> int:
        return self.split.get(name, (0, ()))[0]

    def whole(self, *pairs) -> list:
        """``(activation, weight name)`` pairs, each activation's last
        dimension following that weight's columns, made whole."""
        out = [t for t, _ in pairs]
        groups = {}
        for j, (t, name) in enumerate(pairs):
            dims = self.split.get(name, (0, ()))[1]
            if dims:
                groups.setdefault((dims, t.dtype), []).append(j)
        for (dims, _), js in groups.items():
            for j, t in zip(js, sharding.gather_columns(
                    [out[j] for j in js], self.dm, dims)):
                out[j] = t
        return out

    def leaf(self, name: str) -> torch.Tensor:
        """A weight whole: a split one is gathered once and kept
        (:data:`_WHOLE_LEAVES`)."""
        w = self.params[name]
        if not self.split.get(name, (0, ()))[1]:
            return self[name]
        local = w.to_local()
        ref = StorageWeakRef(local.untyped_storage())
        key = (ref.cdata, local.storage_offset(), tuple(local.shape),
               local.stride(), local.dtype)
        for k in [k for k, v in _WHOLE_LEAVES.items() if v[0].expired()]:
            del _WHOLE_LEAVES[k]
        kept = _WHOLE_LEAVES.get(key)
        if kept is None or kept[1] != local._version:
            kept = _WHOLE_LEAVES[key] = (ref, local._version,
                                         sharding.full(w))
        return kept[2]


def _decode_on_rows(step, params: dict, x, cfg: ArchConfig, state,
                    conv_buf, fused: bool):
    """A decode ``step`` of a placed SSM state (``cache_specs`` splits
    only its batch rows, so every process holds its rows' whole state):
    each process runs ``step`` on its own rows and its own blocks of the
    weights (:class:`_Blocks`).  The in-projections and the conv give
    this process's columns of the step's activations; those are gathered
    whole (the raw all-gather), every process updates the whole state
    and conv taps of its rows in place from them, and the output
    projection's ``d_model`` columns are gathered last.  No weight
    moves, but Mamba-1's ``a_log``, gathered once
    (:meth:`_Blocks.leaf`); the output is placed as the state's rows
    are."""
    dm, rows = state.device_mesh, list(state.placements)
    if any(p not in (Shard(0), Replicate()) for p in rows) or \
            list(conv_buf.placements) != rows:
        raise ValueError(f"an SSM state placed {rows}, its conv taps "
                         f"{list(conv_buf.placements)}: only batch rows may "
                         "be split")
    out = step(_Blocks(params, dm), sharding.redistribute(x, rows).to_local(),
               cfg, state.to_local(), conv_buf.to_local(), fused)
    return (DTensor.from_local(out, dm, rows, run_check=False), state,
            conv_buf)
