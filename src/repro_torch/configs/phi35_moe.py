"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]

32L, d_model=4096, 32H (GQA kv=8), d_ff=6400, vocab=32064, MoE 16 experts top-2.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
