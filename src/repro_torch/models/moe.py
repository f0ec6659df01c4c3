"""Mixture-of-Experts block — port of ``repro/models/moe.py`` (``init_moe``,
``capacity``, ``moe_block`` and its two dispatch paths, and the
training loss ``aux_load_balance_loss``).

Tokens are dispatched within their group (one sequence), GShard style:

1. router logits (float32) -> softmax -> top-k expert ids and gates,
   renormalised over the k;
2. each group's (token, k) entries ranked inside their expert;
3. entries ranked at or past the capacity ``C`` are dropped;
4. kept entries gathered into (G, E, C, D) slots, the experts' SwiGLU
   run as batched products over E, and the gated outputs combined back
   onto their tokens.

``cfg.moe_dispatch`` picks the reference's path: ``"gather"`` (stable
argsort + searchsorted ranks, the default) or ``"einsum"`` (one-hot
cumsum ranks, dispatch and combine as contractions).  Arctic's
``dense_residual`` adds a dense MLP in parallel.

Tie rules.  ``torch.topk(sorted=True)`` orders the k experts by
probability; among exactly equal probabilities ``lax.top_k`` takes the
lower index first and ``torch.topk`` promises no order, so an expert
whose probability ties, or nearly ties (float32 summation order), the
k-th and (k+1)-th may differ from the reference's.  Ranks use a stable
argsort and a left ``searchsorted``, as the reference does, so which
entry of an overfull expert is dropped follows batch order.

The combine is deterministic: each token adds its kept entries' gated
outputs in the reference's scatter order (ascending slot, i.e.
ascending expert), rounding to bf16 after every add as the reference's
bf16 ``y.at[tok].add`` does, instead of an atomic ``index_add_`` whose
summation order (and so bf16 rounding) varies from run to run.

Placed over a mesh (the reference's expert parallelism: ``param_specs``
splits each expert's hidden width over ``model``), the gather path runs
on each process's blocks (:func:`_moe_block_placed`): dispatch on its own
batch rows, its slices of every expert, and the combine's partial sums
added over ``model`` in float32.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
from repro_torch.models import layers


def moe_shapes(cfg: ArchConfig, lead: tuple = ()) -> dict:
    """Leaf shapes of one block's ``moe`` subtree (``lead`` prefixes
    every leaf, the group axis of a stacked block)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    p = {"router": lead + (d, e), "w_up": lead + (e, d, f),
         "w_gate": lead + (e, d, f), "w_down": lead + (e, f, d)}
    if cfg.dense_residual:
        dense = {"w_up": lead + (d, cfg.d_ff), "w_down": lead + (cfg.d_ff, d)}
        if cfg.mlp_gated:
            dense["w_gate"] = lead + (d, cfg.d_ff)
        p["dense"] = dense
    return p


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters with the reference's scales: the router at
    0.02, every other leaf ``shape[0] ** -0.5`` (``dense_init``; for the
    expert stacks that is ``n_experts ** -0.5``, as in the reference)."""
    def fill(path, shape):
        if isinstance(shape, dict):
            return {k: fill(path + (k,), v) for k, v in shape.items()}
        scale = 0.02 if path[-1] == "router" else None
        return layers.dense_init(gen, shape, scale=scale)

    return fill((), moe_shapes(cfg))


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    """Slots per expert for a group of ``tokens_per_group`` tokens: a
    prefill's capacity follows its length, a decode step's is 1."""
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts
            * cfg.capacity_factor)
    return max(c, 1)


def route(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """(G, N, D) bf16 -> gates (G, N, K) float32 renormalised over the k,
    expert ids (G, N, K) int64 in descending probability, and the full
    (G, N, E) float32 probabilities."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_ix = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gate_w, expert_ix, probs


def moe_block(params: dict, x: torch.Tensor, cfg: ArchConfig,
              return_routing: bool = False):
    """x (B, S, D) -> (B, S, D); groups are the B sequences.  With
    ``return_routing`` also the (B, S, K) expert ids and the (B, S, E)
    router probabilities."""
    fn = (_moe_block_einsum if getattr(cfg, "moe_dispatch", "gather")
          == "einsum" else _moe_block_gather)
    y, expert_ix, probs = fn(params, x, cfg)
    if cfg.dense_residual:
        y = y + layers.mlp_block(params["dense"], x, cfg)
    if return_routing:
        return y, expert_ix, probs
    return y


def _experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their slots: (G, E, C, D) bf16 ->
    (G, E, C, D) bf16, as one batched product over E per weight (every
    expert's weights are read, empty slots included)."""
    g, e, c, d = xe.shape
    xt = xe.transpose(0, 1).reshape(e, g * c, d)
    w = lambda name: params[name].to(xt.dtype)    # jnp's dtype promotion
    up = torch.bmm(xt, w("w_up"))
    h = layers.silu(torch.bmm(xt, w("w_gate"))) * up
    out = torch.bmm(h, w("w_down"))
    return out.reshape(e, g, c, d).transpose(0, 1)


def _dispatch(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """Routing and slot assignment of the gather path: (slots (G, E, C,
    D) bf16 of the kept entries' tokens, their gates (G, E * C),
    each token's k slot indices in ascending order (G, S, K; a dropped
    entry's is the trash slot E * C), expert ids, probabilities)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    dev = x.device
    gate_w, expert_ix, probs = route(params, x, cfg)

    # Rank of each (token, k) entry inside its expert, per group.
    flat_e = expert_ix.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    first = torch.searchsorted(sorted_e, experts, right=False)
    rank = (torch.arange(s * k, device=dev)[None, :]
            - torch.gather(first, 1, sorted_e))
    keep = rank < c
    dest = torch.where(keep, sorted_e * c + rank, e * c)   # e*c: trash

    # Slot -> token and gate.  Every live slot has one writer; the trash
    # slot e*c takes all dropped entries and is cut off.
    tok_of_entry = order // k
    w_of_entry = torch.gather(gate_w.reshape(b, s * k), 1, order)
    slot_tok = torch.zeros((b, e * c + 1), dtype=torch.int64, device=dev)
    slot_tok.scatter_(1, dest, tok_of_entry)
    slot_w = torch.zeros((b, e * c + 1), dtype=gate_w.dtype, device=dev)
    slot_w.scatter_(1, dest, torch.where(keep, w_of_entry, 0.0))
    slot_tok, slot_w = slot_tok[:, :e * c], slot_w[:, :e * c]

    xe = torch.gather(x, 1, slot_tok[:, :, None].expand(b, e * c, d))
    dest_of_entry = torch.empty_like(dest).scatter_(1, order, dest)
    tok_dests = dest_of_entry.reshape(b, s, k).sort(dim=-1).values
    return xe.reshape(b, e, c, d), slot_w, tok_dests, expert_ix, probs


def _gated(out: torch.Tensor, slot_w: torch.Tensor) -> torch.Tensor:
    """The experts' (G, E, C, D) outputs times their gates, as (G, E * C
    + 1, D) with a zero row at the trash slot E * C."""
    b, e, c, d = out.shape
    out = (out * slot_w.reshape(b, e, c, 1).to(out.dtype)).reshape(
        b, e * c, d)
    return torch.cat([out, out.new_zeros((b, 1, d))], dim=1)


def _moe_block_gather(params: dict, x: torch.Tensor, cfg: ArchConfig):
    if isinstance(x, DTensor):
        return _moe_block_placed(params, x, cfg)
    b, s, d = x.shape
    xe, slot_w, tok_dests, expert_ix, probs = _dispatch(params, x, cfg)
    out = _gated(_experts(params, xe), slot_w)
    # Combine: each token's entries in ascending slot order (the
    # reference's scatter order), a bf16 rounding after every add; a
    # dropped entry reads the zero row at slot e*c.
    y = torch.zeros((b, s, d), dtype=out.dtype, device=x.device)
    for j in range(cfg.top_k):
        idx = tok_dests[:, :, j, None].expand(b, s, d)
        y = y + torch.gather(out, 1, idx)
    return y.to(x.dtype), expert_ix, probs


#: The dimension of each expert weight that holds the hidden width.
_HIDDEN_DIM = {"w_up": 2, "w_gate": 2, "w_down": 1}


def _moe_block_placed(params: dict, x: DTensor, cfg: ArchConfig):
    """:func:`_moe_block_gather` of placed tensors, on each process's
    blocks (``sharding.local_map``): the dispatch (routing, ranks,
    gather) on its own batch rows with the router whole (dispatch stays
    group-local, so it moves no token), its slices of every expert's
    hidden width (the weights' placements; any other split is gathered
    first).  Where ``model`` splits the hidden width each process holds a
    partial sum of each token's k slots, added in float32, and the mesh
    adds the partial sums (a ``Partial`` all-reduce, in float32),
    rounding once to bf16: one rounding where the one-process combine
    rounds after every add, within the bf16 bound of it.  With whole
    experts on every process the rows run the one-process block."""
    dm = x.device_mesh
    rows = sharding.row_placements(x)
    whole = [Replicate()] * dm.ndim
    names = ("router",) + tuple(_HIDDEN_DIM)
    w_pl = [whole] + [[p if p == Shard(dim) else Replicate()
                       for p in _placements(params[name], dm)]
                      for name, dim in _HIDDEN_DIM.items()]
    split = [p == Shard(1) for p in w_pl[-1]]        # w_down's hidden dim
    y_pl = [Partial() if split[i] else rows[i] for i in range(dm.ndim)]

    def run(xl, *ws):
        p = dict(zip(names, ws))
        if not any(split):       # whole experts: the one-process block
            return _moe_block_gather(p, xl, cfg)
        xe, slot_w, tok_dests, expert_ix, probs = _dispatch(p, xl, cfg)
        out = _gated(_experts(p, xe), slot_w).float()
        b, s, d = xl.shape
        y = torch.zeros((b, s, d), dtype=torch.float32, device=xl.device)
        for j in range(cfg.top_k):
            idx = tok_dests[:, :, j, None].expand(b, s, d)
            y = y + torch.gather(out, 1, idx)
        return y, expert_ix, probs

    y, expert_ix, probs = sharding.local_map(
        run, (x,) + tuple(params[n] for n in names), [rows] + w_pl,
        (y_pl, rows, rows))
    return sharding.redistribute(y, rows).to(x.dtype), expert_ix, probs


def _placements(t, dm) -> list:
    return list(t.placements) if isinstance(t, DTensor) \
        else [Replicate()] * dm.ndim


def _moe_block_einsum(params: dict, x: torch.Tensor, cfg: ArchConfig):
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    dev = x.device
    gate_w, expert_ix, probs = route(params, x, cfg)

    # Position in expert by cumsums (GShard §3.2): entries of earlier
    # tokens rank first, then earlier k-slots of this token.
    eo = (expert_ix[..., None] == torch.arange(e, device=dev)).float()
    tok_e = eo.sum(dim=2)                                     # (G, N, E)
    excl_n = torch.cumsum(tok_e, dim=1) - tok_e
    within = torch.cumsum(eo, dim=2) - eo
    pos = excl_n[:, :, None, :] + within                      # (G, N, K, E)
    pos_in_e = (pos * eo).sum(dim=-1)                         # (G, N, K)
    keep = pos_in_e < c
    gate_w = gate_w * keep.to(gate_w.dtype)
    slot_ix = torch.where(keep, pos_in_e, float(c))
    slot = (slot_ix[..., None] == torch.arange(c, device=dev)).float()
    combine = torch.einsum("gnk,gnke,gnkc->gnec", gate_w, eo, slot)
    dispatch = (combine > 0).to(x.dtype)                      # (G, N, E, C)

    xe = torch.einsum("gnd,gnec->gecd", x, dispatch)
    out = _experts(params, xe)
    y = torch.einsum("gecd,gnec->gnd", out, combine.to(out.dtype))
    return y.to(x.dtype), expert_ix, probs


def aux_load_balance_loss(params: dict, x: torch.Tensor,
                          cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary: ``E * sum(fraction of tokens
    whose top-1 expert is e * mean router probability of e)``, float32."""
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.nn.functional.one_hot(top1, cfg.n_experts).float().mean(
        dim=(0, 1))
    return cfg.n_experts * (frac * probs.mean(dim=(0, 1))).sum()
