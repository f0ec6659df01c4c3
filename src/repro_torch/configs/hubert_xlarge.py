"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only, same backbone as wav2vec2.  [arXiv:2106.07447; unverified]

The conv feature-extractor frontend is a STUB per the assignment:
``input_specs()`` feeds precomputed frame embeddings (B, T, d_model).
Encoder-only: no decode shapes (skip matrix in configs.base).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    mlp_gated=False,         # w2v2-style plain GELU FFN
    source="arXiv:2106.07447; unverified",
)
