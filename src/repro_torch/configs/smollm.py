"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L, d_model=576, 9H (GQA kv=3, head_dim=64), d_ff=1536, vocab=49152, tied
embeddings.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
