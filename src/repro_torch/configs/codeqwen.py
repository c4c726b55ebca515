"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch (qkv bias).

32L, d_model=4096, 32H (GQA kv=32 → MHA), d_ff=13440, vocab=92416.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    attn_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
)
