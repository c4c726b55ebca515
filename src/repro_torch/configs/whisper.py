"""whisper-small [arXiv:2212.04356] — encoder-decoder audio backbone.

12L encoder + 12L decoder, d_model=768, 12H (kv=12), d_ff=3072, vocab=51865,
LayerNorm + GELU, non-gated FFN, biases everywhere, tied decoder embeddings.
The mel-spectrogram + conv frontend is a stub: ``input_specs`` provides
precomputed frame embeddings (B, 1500, d_model) consumed by the encoder.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    num_audio_frames=1500,
    norm="layernorm",
    act="gelu",
    glu=False,
    ffn_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
