"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262_144,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_pattern=5,   # 5 local : 1 global
    logit_softcap=0.0,
    source="hf:google/gemma-3-1b-pt (27b scaling); unverified",
)
