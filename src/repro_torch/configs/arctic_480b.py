"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Arctic is a dense-MoE hybrid: every layer runs a dense FFN residual path in
parallel with the 128-expert top-2 MoE (``dense_residual=True``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab_size=32_000,
    rope_theta=10_000.0,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
