"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b family, 12B variant]

40L, d_model=5120, 32H (GQA kv=8, head_dim=160), d_ff=13824, vocab=100352.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    source="hf:stabilityai/stablelm-2-1_6b",
)
