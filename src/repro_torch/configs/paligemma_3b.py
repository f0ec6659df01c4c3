"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP vision frontend + gemma decoder.
[arXiv:2407.07726; hf]

The SigLIP frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed patch embeddings (B, 256, d_model); the decoder prefix-attends
to them (full attention over prefix+text).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,            # MQA
    d_head=256,
    d_ff=16384,
    vocab_size=257_216,
    rope_theta=10_000.0,
    n_prefix_embeds=256,     # 224/14 = 16x16 patches
    source="arXiv:2407.07726; hf",
)
