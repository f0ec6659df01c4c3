"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

The shared attention block (attention + MLP with TIED parameters across all
its invocations) is applied every 6th layer; the other layers are Mamba2.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,           # MHA inside the shared block
    d_head=80,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    shared_attn_every=6,
    source="arXiv:2411.15242; hf",
)
