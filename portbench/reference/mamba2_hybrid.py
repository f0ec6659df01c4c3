"""Plain float32 reference of a Mamba-2 stack with a tied attention
block (Zamba2, arXiv:2411.15242).

Layers come in groups of ``shared_attn_every``: that many minus one
Mamba-2 blocks, then the one shared attention + MLP block (the same
weights at every call; ``common.attention_block``).  A Mamba-2 block is
``x + out_proj(norm_g(y * silu(z)))`` of ``norm(x)``, where ``z``,
``xBC`` and ``dt`` are its input projections, ``xBC`` goes through a
causal depthwise convolution and silu and splits into the heads' inputs
``x`` (H heads of P), ``B`` and ``C`` (N each, shared by the heads),
``dt = softplus(dt + dt_b)``, and per head

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t

from ``h_0 = 0`` with ``A = -exp(a_log)``.  The scan runs as the
state-space dual in chunks of :data:`CHUNK` steps (quadratic within a
chunk, the state carried between chunks), the same sums as the
recurrence (``scan_recurrent`` states it step by step; a test holds the
two equal).  Departures from the published model are the program's,
listed in the configuration file.  Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common

F32 = torch.float32
#: Steps a chunk of the scan (the program's own chunk is another).
CHUNK = 64


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal convolution: out_t = sum_i w[i] x_{t-K+1+i} + b,
    zeros before the sequence.  x (R, S, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = b.to(F32).expand_as(x).clone()
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(F32)
    return out


def scan_recurrent(x, dt, a, b, c):
    """The recurrence step by step (for tests): x (R, S, H, P), dt
    (R, S, H), a (H,), b and c (R, S, N) -> y (R, S, H, P)."""
    r, s, h, p = x.shape
    state = torch.zeros(r, h, p, b.shape[-1], dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[:, :, None, None]
        state = decay * state + (dt[:, t, :, None, None] * x[:, t, :, :, None]
                                 * b[:, t, None, None, :])
        ys.append(torch.einsum("rhpn,rn->rhp", state, c[:, t]))
    return torch.stack(ys, 1)


def scan(x, dt, a, b, c, chunk: int = CHUNK):
    """The same sums as :func:`scan_recurrent`, chunk by chunk."""
    r, s, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros(r, h, p, n, dtype=F32, device=x.device)
    y = torch.empty(r, s, h, p, dtype=F32, device=x.device)
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        la = dt[:, lo:hi] * a                                  # (R, L, H)
        cs = torch.cumsum(la, 1)
        seg = cs[:, :, None, :] - cs[:, None, :, :]            # (R, i, j, H)
        ll = hi - lo
        below = torch.ones(ll, ll, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~below[None, :, :, None],
                                          -torch.inf))
        u = x[:, lo:hi] * dt[:, lo:hi, :, None]                # dt x
        cb = torch.einsum("rin,rjn->rij", c[:, lo:hi], b[:, lo:hi])
        y_in = torch.einsum("rijh,rjhp->rihp", cb[..., None] * decay, u)
        y_st = torch.einsum("rin,rhpn->rihp", c[:, lo:hi], state) \
            * torch.exp(cs)[..., None]
        y[:, lo:hi] = y_in + y_st
        to_end = torch.exp(cs[:, -1:, :] - cs)                 # (R, L, H)
        state = state * torch.exp(cs[:, -1])[:, :, None, None] + torch.einsum(
            "rjhp,rjn->rhpn", to_end[..., None] * u, b[:, lo:hi])
    return y


def mamba2_block(p: dict, x: torch.Tensor, m: dict, eps: float,
                 precision: str) -> torch.Tensor:
    """x + the Mamba-2 mixer of norm(x); x (R, S, D) float32."""
    r, s, _ = x.shape
    s_p = p["ssm"]
    n, hp = m["ssm_state"], m["ssm_head_dim"]
    di = m["ssm_expand"] * m["d_model"]
    heads = di // hp
    hn = common.rms_norm(x, p["ln1"], eps)
    z = common.mm(hn, s_p["wz"], precision)
    xbc = common.silu(causal_conv(common.mm(hn, s_p["wxbc"], precision),
                                  s_p["conv_w"], s_p["conv_b"]))
    xh, b, c = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(common.mm(hn, s_p["wdt"], precision)
                    + s_p["dt_b"].to(F32))
    a = -torch.exp(s_p["a_log"].to(F32))
    xh = xh.reshape(r, s, heads, hp)
    y = scan(xh, dt, a, b, c) + xh * s_p["d_skip"].to(F32)[:, None]
    g = common.rms_norm(y.reshape(r, s, di) * common.silu(z),
                        s_p["norm_w"], eps)
    return x + common.mm(g, s_p["out_proj"], precision)


def logits(weights: dict, config: dict, tokens: torch.Tensor,
           first_out: int, precision: str = "f32") -> torch.Tensor:
    """(R, S - first_out, V) float32 logits of every position from
    ``first_out`` on, for ``tokens`` (R, S) on the weights' device."""
    m, eps = config["model"], config["assumed"]["rms_eps"]
    every = m["shared_attn_every"]
    n_groups, n_rem = divmod(m["n_layers"], every)
    with common.float32_matmuls(), torch.no_grad():
        x = common.embed(weights, tokens, m["d_model"])
        for g in range(n_groups):
            for i in range(every - 1):
                x = mamba2_block(common.layer(weights["groups"][f"b{i}"], g),
                                 x, m, eps, precision)
            x = common.attention_block(weights["shared"], x, m, eps,
                                       precision)
        for i in range(n_rem):
            x = mamba2_block(weights[f"rem{i}"], x, m, eps, precision)
        return common.head(weights, x[:, first_out:], eps, precision)
