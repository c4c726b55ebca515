"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality), attention-free.

48L, d_model=1024 (d_inner=2048, 32 SSD heads × P=64), ssm_state N=128,
vocab=50280, tied embeddings.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    use_rope=False,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
