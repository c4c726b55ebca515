"""quasar-paper-7b — the paper's own model scale (OpenPangu-7B / Qwen3-8B
class dense decoder).  [paper §4.1; hf:Qwen/Qwen3-8B]
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="quasar-paper-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    rope_theta=1000000.0,
    source="paper §4.1 (Qwen3-8B / OpenPangu-7B class)",
)
