"""Model assembly — port of ``repro/models/transformer.py``: every block
kind of ``configs/base.py`` (global and sliding-window local attention,
each followed by a dense MLP or an MoE block; Mamba-1 and Mamba-2 blocks;
zamba2's shared attention block) through init, the training forward and
loss, the decode caches, prefill and decode.

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
                       # or, for an SSM block, only "ln1" and "ssm"
                "b1": ..., },
     "shared": {"ln1", "attn", "ln2", "mlp"},     # zamba2 only
     "rem0": {"ln1": (D,), ...}, "rem1": ...}

An all-global model (yi-9b) is one ``b0`` group per layer and no
remainder; gemma3-27b's 62 layers are 10 groups of [local x 5, global]
plus ``rem0``, ``rem1`` (both local); zamba2-2.7b's 54 are 9 groups of
[Mamba-2 x 5, shared].  The shared block's parameters are one block
outside ``groups`` (tied across its calls), so the group has no ``b5``
parameters, but each call keeps its own cache slot ``groups.b5[g]``.
Caches have the same keys: ``{"k", "v"}`` leaves (G, B, S, KV, dh) in a
group and (B, S, KV, dh) in the remainder, a local block's a ring of
``min(max_seq, sliding_window)`` slots; an SSM block's ``{"h", "conv"}``
(float32 state, bf16 conv taps).  KV trees hold the attention blocks
only.  The reference's ``lax.scan`` over the groups is a Python loop.

Placed over a ``torch.distributed`` mesh (``DTensor`` parameters,
``dist/sharding.py``), :func:`prefill` and :func:`decode_step` serve on
every process of the mesh: the prompt's rows are placed by
``batch_specs``, the caches by ``cache_specs`` (:func:`init_cache`), and
the steps run under DTensor's ``implicit_replication``, as the train
step does.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MAMBA1,
                                      MAMBA2, SHARED_ATTN, ArchConfig)
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.models import layers, moe, ssm
from repro_torch.pytree import tree_leaves, tree_map

DTYPE = layers.DTYPE


def _is_attn(kind: str) -> bool:
    return kind in (ATTN_GLOBAL, ATTN_LOCAL, SHARED_ATTN)


def _check_kind(kind: str) -> None:
    if not _is_attn(kind) and kind not in (MAMBA1, MAMBA2):
        raise ValueError(kind)


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
    (a view into the stacked leaves, or the g-th of a leaf that
    :func:`forward` has unbound into a tuple) or in the remainder."""
    if g is None:
        return tree[key]
    return tree_map(lambda a: a[g], tree["groups"][key])


def _params_of(params: dict, key: str, g: int | None, kind: str) -> dict:
    """A layer's parameters: the tied ``shared`` block for a shared
    attention layer, else its own block."""
    return params["shared"] if kind == SHARED_ATTN else _block(params, key, g)


def _stacked(cfg: ArchConfig, fn) -> dict:
    """A tree with ``fn(kind, lead)`` for each block: ``lead = (G,)`` for
    the group's blocks and ``()`` for the remainder's; a block for which
    ``fn`` gives None has no entry."""
    group, n_groups, rem = cfg.scan_groups()
    out = {}
    if n_groups > 0:
        groups = {f"b{i}": fn(kind, (n_groups,))
                  for i, kind in enumerate(group)}
        groups = {k: v for k, v in groups.items() if v is not None}
        if groups:
            out["groups"] = groups
    for i, kind in enumerate(rem):
        v = fn(kind, ())
        if v is not None:
            out[f"rem{i}"] = v
    return out


def param_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree with ``(shape, dtype)`` leaves (group axis
    leading in ``groups``)."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    bf = lambda *shape: (shape, DTYPE)
    embed = {"embed": bf(cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = bf(d, cfg.vocab_size)

    def block(kind, lead):
        _check_kind(kind)
        out = {"ln1": bf(*lead, d)}
        if kind == MAMBA1:
            out["ssm"] = ssm.mamba1_shapes(cfg, lead)
            return out
        if kind == MAMBA2:
            out["ssm"] = ssm.mamba2_shapes(cfg, lead)
            return out
        out["attn"] = {"wq": bf(*lead, d, hd), "wk": bf(*lead, d, kvd),
                       "wv": bf(*lead, d, kvd), "wo": bf(*lead, hd, d)}
        out["ln2"] = bf(*lead, d)
        if cfg.n_experts and kind != SHARED_ATTN:
            out["moe"] = tree_map(lambda s: (s, DTYPE),
                                  moe.moe_shapes(cfg, lead))
            return out
        mlp = {"w_up": bf(*lead, d, cfg.d_ff), "w_down": bf(*lead, cfg.d_ff, d)}
        if cfg.mlp_gated:
            mlp["w_gate"] = bf(*lead, d, cfg.d_ff)
        out["mlp"] = mlp
        return out

    tree = {"embed": embed, "final_ln": bf(d),
            **_stacked(cfg, lambda kind, lead: None if kind == SHARED_ATTN
                       else block(kind, lead))}
    if SHARED_ATTN in cfg.layer_pattern():
        tree["shared"] = block(SHARED_ATTN, ())
    return tree


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> dict:
    """Random parameters on ``device`` from a seeded ``torch.Generator``
    on that device, with the reference's ``dense_init`` scales
    (``fan_in ** -0.5``, 0.02 for the embedding and the MoE router, zero
    norm weights) and its SSM leaves (``ssm.init_leaf``: deterministic
    ``a_log``, ``dt_b``, ``d_skip``, ``conv_b``, ``norm_w``; float32 where
    the reference keeps float32).  The random bits differ from JAX's;
    tests carry JAX's weights across with :func:`params_from_numpy`
    instead.  Layers are drawn one at a time so the float32 draw never
    holds more than one layer's leaf.  A ``generator`` (on ``device``)
    replaces the one made from ``seed``."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

    def one(path, shape, dtype):
        name = path[-1]
        if "ssm" in path:
            return ssm.init_leaf(gen, name, shape, dtype, dev)
        if name in ("ln1", "ln2", "final_ln"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        scale = 0.02 if name in ("embed", "router") else None
        return layers.dense_init(gen, shape, scale=scale, dtype=dtype,
                                 device=dev)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        shape, dtype = tree
        if path[0] != "groups":               # embedding, shared, remainder
            return one(path, shape, dtype)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):             # stacked: one layer at a time
            out[i] = one(path, shape[1:], dtype)
        return out

    return walk(param_shapes(cfg))


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                  # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree, given as numpy arrays (bf16 as
    ``ml_dtypes.bfloat16``), as the port's parameters on ``device``.
    Keys, shapes and dtypes must match :func:`param_shapes` exactly."""
    dev = resolve_device(device)

    def walk(t, s, path=()):
        if isinstance(s, dict):
            if not isinstance(t, dict) or set(t) != set(s):
                raise ValueError(f"parameter tree at {'/'.join(path) or '/'} "
                                 f"has keys {sorted(t) if isinstance(t, dict) else t}"
                                 f", expected {sorted(s)}")
            return {k: walk(t[k], s[k], path + (k,)) for k in s}
        shape, dtype = s
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        out = _to_tensor(t, dev)
        if out.dtype != dtype:
            raise ValueError(f"{'/'.join(path)}: dtype {t.dtype}, expected "
                             f"{dtype}")
        return out

    return walk(tree, param_shapes(cfg))


def param_count(params: dict) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _device_of(params: dict) -> torch.device:
    return params["final_ln"].device


def _mesh_of(params: dict):
    """The ``DeviceMesh`` the parameters are placed over, or None."""
    leaf = params["final_ln"]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def _placed(params: dict):
    """DTensor's ``implicit_replication`` for placed parameters (the plain
    tensors a step builds join them as replicated), else nothing."""
    return (implicit_replication() if _mesh_of(params) is not None
            else contextlib.nullcontext())


def _tokens(tokens, device, mesh=None) -> torch.Tensor:
    """Token ids as int64 on ``device``; over a ``mesh``, placed by their
    rows (``sharding.batch_specs``)."""
    if isinstance(tokens, DTensor):
        return tokens.long()
    t = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                        else tokens, device=device).long()
    if mesh is None:
        return t
    return sharding.place_leaf(t, sharding.batch_specs(t, mesh), mesh)


def _embed_scaled(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    # sqrt(d_model) rounded to bf16 on the host, as the reference's bf16
    # constant (a scalar tensor made on the card would block the host)
    scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=DTYPE))
    return layers.embed(params["embed"], tokens) * scale


def _input_embeds(params: dict, cfg: ArchConfig, batch: dict):
    """The stack's input (B, S, D) bf16 from ``batch["embeds"]`` (B, P, D)
    (a VLM's patches, an audio model's frames; tensor or numpy) followed
    by the scaled embeddings of ``batch["tokens"]``, and its positions
    0..S-1."""
    dev = _device_of(params)
    parts = []
    if "embeds" in batch:
        e = batch["embeds"]
        e = e.to(dev) if torch.is_tensor(e) else _to_tensor(e, dev)
        parts.append(e.to(DTYPE))
    if "tokens" in batch:
        parts.append(_embed_scaled(params, cfg, _tokens(
            batch["tokens"], dev, _mesh_of(params))))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    b, s, _ = x.shape
    return x, torch.arange(s, device=dev)[None].expand(b, s)


# ---------------------------------------------------------------------------
# One block, and the stack.
# ---------------------------------------------------------------------------

def _ffn(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A block's feed-forward half: its MoE block, or its dense MLP."""
    if "moe" in p:
        return moe.moe_block(p["moe"], h, cfg)
    return layers.mlp_block(p["mlp"], h, cfg)


def _apply_block(p: dict, cfg: ArchConfig, kind: str, key: str,
                 g: int | None, x: torch.Tensor, x32: torch.Tensor | None,
                 mix):
    """One block, ``x + mix(norm(x))`` — ``mix`` is the attention or the
    SSM — then for an attention block ``+ ffn(norm)`` (the MLP, or the MoE
    block of an MoE config); returns the bf16 residual and, inside a
    group, its float32 sum.

    Inside a group each norm reads the float32 sum of the residual add
    before it, not its bf16 rounding, as the reference's compiled scan
    body does: XLA drops the bf16 round trip between an add and the
    float32 norm within one compiled body.  So ``x32`` carries the
    previous block's sum within one group iteration (after an SSM block
    too, and into zamba2's shared block); the first block of an iteration
    reads the bf16 scan carry, and the remainder blocks, which the
    reference runs op by op, round every add."""
    fused = g is not None
    h = layers.rms_norm(x32 if fused and key != "b0" else x,
                        p["ln1"]).to(DTYPE)
    s1 = x.float() + _like(mix(h).float(), x)
    if not _is_attn(kind):
        return s1.to(DTYPE), s1 if fused else None
    x = s1.to(DTYPE)
    h2 = layers.rms_norm(s1 if fused else x, p["ln2"]).to(DTYPE)
    s2 = x.float() + _like(_ffn(p, h2, cfg).float(), x)
    return s2.to(DTYPE), s2 if fused else None


def _like(t: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """A block's (float32) output in the residual stream's placements (a
    partial sum reduced, a split sequence gathered), where both are
    placed: the stream keeps its layout from block to block."""
    if isinstance(t, DTensor) and isinstance(residual, DTensor) and \
            t.placements != residual.placements:
        return sharding.redistribute(t, residual.placements)
    return t


def _run_stack(params: dict, cfg: ArchConfig, x: torch.Tensor, mixer, *,
               remat: bool = False):
    """``x`` through every layer, ``mixer(key, g, kind, p)`` giving each
    block's ``mix``; returns the final-normed hidden states.

    Layer group by layer group, then the remainder blocks: the float32
    sum ``x32`` never crosses a group's end (the next group's ``b0``
    reads the bf16 carry).  ``remat`` runs each group under
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its scan body: a group keeps only its input for the backward pass and
    runs again there.  The forward values are the same either way."""
    group, n_groups, rem = cfg.scan_groups()

    def run(x, blocks):
        x32 = None
        for key, g, kind in blocks:
            p = _params_of(params, key, g, kind)
            x, x32 = _apply_block(p, cfg, kind, key, g, x, x32,
                                  mixer(key, g, kind, p))
        return x

    for g in range(n_groups):
        blocks = [(f"b{i}", g, kind) for i, kind in enumerate(group)]
        if remat:
            x = checkpoint(run, x, blocks, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = run(x, blocks)
    x = run(x, [(f"rem{i}", None, kind) for i, kind in enumerate(rem)])
    return layers.rms_norm(x, params["final_ln"])


_SSM_BLOCK = {MAMBA1: ssm.mamba1_block, MAMBA2: ssm.mamba2_block}
_SSM_DECODE = {MAMBA1: ssm.mamba1_decode, MAMBA2: ssm.mamba2_decode}


def forward(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The trunk over ``batch`` ("tokens" and/or "embeds"): the final
    hidden states (B, S, D) bf16, every position (the training and
    encoder path).  With grad enabled each layer group is rematerialised
    (:func:`_run_stack`), and a group's stacked leaves are split once
    with ``unbind`` so their gradients are stacked once, not summed from
    one zero-padded copy per group."""
    remat = torch.is_grad_enabled()
    if remat and "groups" in params:
        params = dict(params, groups=tree_map(lambda a: a.unbind(0),
                                              params["groups"]))
    x, positions = _input_embeds(params, cfg, batch)

    def mixer(key, g, kind, p):
        if _is_attn(kind):
            return lambda h: layers.attention_block(
                p["attn"], h, cfg, positions, local=kind == ATTN_LOCAL)
        return lambda h: _SSM_BLOCK[kind](p["ssm"], h, cfg,
                                          fused=g is not None)

    return _run_stack(params, cfg, x, mixer, remat=remat)


def train_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["labels"]`` (-1 =
    masked); a VLM's loss covers only the text after its prefix embeds."""
    x = forward(params, cfg, batch)
    labels = _tokens(batch["labels"], x.device)
    if "embeds" in batch and "tokens" in batch:
        x = x[:, batch["embeds"].shape[1]:]
    loss = layers.chunked_ce_loss(params["embed"], x, labels)
    if cfg.n_experts:
        # the reference's aux load-balance term is a no-op here: no term
        # is added (moe.aux_load_balance_loss is its own entry point)
        pass
    return loss


# ---------------------------------------------------------------------------
# Decode caches, prefill and decode.
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's tree with ``(shape, dtype)`` leaves."""
    def block(kind, lead):
        _check_kind(kind)
        k1 = cfg.ssm_conv - 1
        if kind == MAMBA1:
            di = ssm.d_inner(cfg)
            return {"h": (lead + (batch, di, cfg.ssm_state), torch.float32),
                    "conv": (lead + (batch, k1, di), DTYPE)}
        if kind == MAMBA2:
            di = ssm.d_inner(cfg) + 2 * cfg.ssm_state
            return {"h": (lead + (batch, ssm.m2_heads(cfg),
                                  cfg.ssm_head_dim, cfg.ssm_state),
                          torch.float32),
                    "conv": (lead + (batch, k1, di), DTYPE)}
        slots = (min(max_seq, cfg.sliding_window) if kind == ATTN_LOCAL
                 else max_seq)                # a local block keeps a ring
        shape = lead + (batch, slots, cfg.n_kv_heads, cfg.d_head)
        return {"k": (shape, DTYPE), "v": (shape, DTYPE)}

    return _stacked(cfg, block)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda", *,
               device_mesh=None) -> dict:
    """Zero decode caches on ``device``; with ``device_mesh``, placed by
    ``sharding.cache_specs``, each process making only its own block."""
    device = resolve_device(device)
    shapes = cache_shapes(cfg, batch, max_seq)
    if device_mesh is None:
        return tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1],
                                               device=device), shapes)
    specs = sharding.cache_specs(shapes, device_mesh)
    return tree_map(lambda sd, sp: sharding.zeros(sd[0], sd[1], sp,
                                                  device_mesh, device),
                    shapes, specs)


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
    if isinstance(bc["k"], DTensor):       # each process writes its block
        w = bc["k"].shape[1]
        take = min(w, s_tot) if local else s_tot
        slots = [t % w for t in range(s_tot - take, s_tot)]
        layers.write_slots(bc["k"], slots, k_all[:, s_tot - take:])
        layers.write_slots(bc["v"], slots, v_all[:, s_tot - take:])
    elif local:
        w = bc["k"].shape[1]
        take = min(w, s_tot)
        slots = torch.arange(s_tot - take, s_tot, device=k_all.device) % w
        bc["k"][:, slots] = k_all[:, s_tot - take:].to(DTYPE)
        bc["v"][:, slots] = v_all[:, s_tot - take:].to(DTYPE)
    else:
        bc["k"][:, :s_tot] = k_all.to(DTYPE)
        bc["v"][:, :s_tot] = v_all.to(DTYPE)


def prefill(params: dict, cfg: ArchConfig, batch: dict, max_seq: int, *,
            prefix_kv: dict | None = None, return_kv: bool = False):
    """Run the stack over a prompt ("tokens" and/or "embeds") and build
    the decode cache.  Returns (last-token logits (B, V) float32, cache),
    plus the per-layer KV of THIS call's tokens (attention blocks only)
    when ``return_kv``.  An SSM block seeds its cache with its final
    state and conv tail.

    ``prefix_kv`` resumes from a cached prefix (post-RoPE k/v of the first
    P prompt tokens, every layer; attention-only configs): ``batch``
    then holds only the suffix, whose positions start at P, and attention
    runs over prefix ++ suffix with ``q_offset=P`` — the same cache and
    logits as a full prefill.  Local layers attend within the sliding
    window and keep the last ``min(W, P + S)`` keys in their ring."""
    if prefix_kv is not None and not resume_supported(cfg):
        raise NotImplementedError(
            f"prefix resume needs attention-only layers; {cfg.name} "
            "has recurrent (SSM) state that chunk slabs cannot restore")
    with _placed(params):
        return _prefill(params, cfg, batch, max_seq, prefix_kv, return_kv)


def _prefill(params, cfg, batch, max_seq, prefix_kv, return_kv):
    dev = _device_of(params)
    mesh = _mesh_of(params)
    x, positions = _input_embeds(params, cfg, batch)
    b, s, _ = x.shape
    p_len = 0 if prefix_kv is None else prefix_length(prefix_kv)
    positions = positions + p_len
    cache = init_cache(cfg, b, max_seq, dev, device_mesh=mesh)

    def kv_block(kind, lead):
        if not _is_attn(kind):
            return None
        shape = lead + (b, s, cfg.n_kv_heads, cfg.d_head)
        return {"k": (shape, DTYPE), "v": (shape, DTYPE)}

    kv_out = None
    if return_kv:
        shapes = _stacked(cfg, kv_block)
        if mesh is None:
            kv_out = tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1],
                                                     device=dev), shapes)
        else:                               # laid out as the cache is
            kv_out = tree_map(
                lambda sd, sp: sharding.zeros(sd[0], sd[1], sp, mesh, dev),
                shapes, sharding.cache_specs(shapes, mesh))

    def mixer(key, g, kind, p):
        bc = _block(cache, key, g)
        if not _is_attn(kind):
            def fill_state(h):
                out, h_final, tail = _SSM_BLOCK[kind](
                    p["ssm"], h, cfg, return_state=True, fused=g is not None)
                _assign(bc["h"], h_final)
                _assign(bc["conv"], tail)
                return out
            return fill_state
        local = kind == ATTN_LOCAL

        def attend(h):
            q, k, v = layers._qkv(p["attn"], h, cfg, positions)
            q = layers._seq_shard(q, cfg)
            k = layers._seq_shard(k, cfg)
            v = layers._seq_shard(v, cfg)
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
            _write_cache(bc, k_all, v_all, local)
            if return_kv:
                kv = _block(kv_out, key, g)
                _assign(kv["k"], k)
                _assign(kv["v"], v)
            return layers.out_proj(out, p["attn"]["wo"])
        return attend

    x = _run_stack(params, cfg, x, mixer)
    logits = layers.unembed_logits(params["embed"], x[:, -1:])[:, 0]
    if return_kv:
        return logits, cache, kv_out
    return logits, cache


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a placed ``dst`` takes ``src`` brought to its
    placements, block by block."""
    if isinstance(dst, DTensor):
        if not isinstance(src, DTensor):
            src = DTensor.from_local(src, dst.device_mesh,
                                     [Replicate()] * dst.device_mesh.ndim,
                                     run_check=False)
        dst.to_local().copy_(
            sharding.redistribute(src, dst.placements).to_local())
    else:
        dst.copy_(src)


def decode_step(params: dict, cfg: ArchConfig, tokens, cache: dict,
                pos: int):
    """tokens: (B, 1) int; pos: the new token's position.  Returns
    (logits (B, V) float32, cache), the cache updated in place: a global
    block writes slot ``pos``, a local block its ring slot ``pos % W``,
    an SSM block its state and conv taps."""
    with _placed(params):
        return _decode_step(params, cfg, tokens, cache, int(pos))


def _decode_step(params, cfg, tokens, cache, pos):
    dev = _device_of(params)
    x = _embed_scaled(params, cfg, _tokens(tokens, dev, _mesh_of(params)))

    def mixer(key, g, kind, p):
        bc = _block(cache, key, g)
        if not _is_attn(kind):
            return lambda h: _SSM_DECODE[kind](p["ssm"], h, cfg, bc["h"],
                                               bc["conv"],
                                               fused=g is not None)[0]
        if kind == ATTN_LOCAL:
            w = bc["k"].shape[1]
            return lambda h: layers.decode_attention_ring(
                p["attn"], h, cfg, bc["k"], bc["v"], pos, pos % w)[0]
        return lambda h: layers.decode_attention(
            p["attn"], h, cfg, bc["k"], bc["v"], pos)[0]

    x = _run_stack(params, cfg, x, mixer)
    logits = layers.unembed_logits(params["embed"], x)[:, 0]
    return logits, cache
