"""Architecture + shape configuration schema.

Every assigned architecture gets one module in this package defining
``CONFIG`` (exact published dimensions) and the registry maps ``--arch``
ids to them.  ``reduced()`` produces the CPU-smoke-test variant of the same
family (few layers, narrow, tiny vocab) — the FULL configs are only ever
lowered via ShapeDtypeStructs in the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# Layer kinds used in `layer_pattern`.
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"       # sliding-window attention
MAMBA1 = "mamba1"
MAMBA2 = "mamba2"
SHARED_ATTN = "shared_attn"     # zamba2-style shared block (tied params)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # Attention details.
    rope_theta: float = 10_000.0
    use_rope: bool = True           # False = NoPE (position-free attention)
    sliding_window: int = 1024
    local_global_pattern: int = 0   # N local layers per 1 global (0 = all global)
    causal: bool = True
    encoder_only: bool = False
    logit_softcap: float = 0.0
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # SSM.
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    shared_attn_every: int = 0      # zamba2: shared attn block cadence
    # Multimodal stub frontends.
    n_prefix_embeds: int = 0        # vlm: image patches; audio: frames are the seq
    # Norm/MLP details.
    mlp_gated: bool = True          # SwiGLU vs plain GELU
    tie_embeddings: bool = False
    # §Perf knobs (beyond-paper; defaults = the measured baseline).
    moe_dispatch: str = "gather"    # "gather" | "einsum" (GShard one-hot)
    # Sequence-sharded attention (megatron-SP style): shard the sequence
    # dim of q/k/v over `model` instead of letting GSPMD fall back to
    # d_head-sharded contractions (which all-reduce fp32 logits planes
    # when n_(kv_)heads %% model != 0).  Value = the DP axis names tuple
    # (("data",) or ("pod", "data")); empty = off.
    attn_seq_shard: Sequence[str] = ()
    source: str = ""

    # ---- derived ------------------------------------------------------
    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def supports_long_context(self) -> bool:
        """long_500k runnable: SSM/hybrid, or local-attention-dominated."""
        return self.family in ("ssm", "hybrid") or self.local_global_pattern > 0

    def layer_pattern(self) -> list[str]:
        """Expanded per-layer kinds, length n_layers."""
        if self.family == "ssm":
            return [MAMBA1] * self.n_layers
        if self.family == "hybrid":
            out = []
            for i in range(self.n_layers):
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    out.append(SHARED_ATTN)
                else:
                    out.append(MAMBA2)
            return out
        if self.local_global_pattern > 0:
            out = []
            for i in range(self.n_layers):
                # N locals then 1 global, repeating (gemma3: 5:1).
                out.append(ATTN_GLOBAL if (i % (self.local_global_pattern + 1)
                                           == self.local_global_pattern)
                           else ATTN_LOCAL)
            return out
        return [ATTN_GLOBAL] * self.n_layers

    def scan_groups(self) -> tuple[list[str], int, list[str]]:
        """(group_pattern, n_groups, remainder_pattern) for scan-over-layers:
        the layer pattern is factored into ``n_groups`` repeats of
        ``group_pattern`` plus a remainder handled unscanned."""
        pat = self.layer_pattern()
        if self.local_global_pattern > 0 or self.family == "hybrid":
            g = (self.local_global_pattern + 1 if self.local_global_pattern
                 else self.shared_attn_every)
        else:
            g = 1
        g = max(g, 1)
        n_groups = len(pat) // g
        rem = pat[n_groups * g:]
        return pat[:g], n_groups, rem

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            sliding_window=32,
            shared_attn_every=3 if self.shared_attn_every else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 16),
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The assignment's skip matrix (also mirrored in DESIGN.md §4)."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return True, ""
