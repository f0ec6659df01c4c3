"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) d_ff=0
vocab=65024, ssm_state=16 — Mamba-1 architecture.  [arXiv:2410.05355;
unverified]

Arch-applicability note (DESIGN.md §4): no KV cache exists, so the
Monarch KV-prefix-cache technique is INAPPLICABLE here; the arch runs
without it (data-pipeline CAM dedup still applies).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,                  # attention-free, MLP-free: pure mamba blocks
    vocab_size=65_024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2410.05355; unverified",
)
