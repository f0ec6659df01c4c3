"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,                # per-expert FFN width
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    source="hf:Qwen/Qwen3-30B-A3B",
)
