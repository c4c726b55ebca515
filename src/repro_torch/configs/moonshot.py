"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]

48L, d_model=2048, 16H (kv=16, MHA), per-expert d_ff=1408, vocab=163840,
MoE 64 experts top-6 (deepseek-v3-style fine-grained experts).
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
