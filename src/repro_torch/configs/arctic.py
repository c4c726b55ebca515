"""arctic-480b [hf:Snowflake/snowflake-arctic-base]

35L, d_model=7168, 56H (GQA kv=8), d_ff=4864, vocab=32000,
MoE 128 experts top-2 with a dense residual MLP branch per layer.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
