"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision]

100L (80 self-attn + 20 cross-attn image layers, every 5th), d_model=8192,
64H (GQA kv=8), d_ff=28672, vocab=128256.  The ViT vision encoder is a stub:
``input_specs`` provides precomputed patch embeddings (B, 1600, d_model).
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
