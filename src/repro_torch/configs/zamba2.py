"""zamba2-2.7b [arXiv:2411.15242]

54L Mamba2 backbone, d_model=2560, shared attention block (32H MHA, kv=32,
d_ff=10240) applied every 6th layer, vocab=32000, ssm_state=64.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    shared_attn=True,
    source="arXiv:2411.15242",
)
