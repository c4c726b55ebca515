"""Configuration dataclasses (port of ``repro.core.config``).

Same three configs, fields and defaults as the reference; ``dtype`` is a
torch dtype.

* :class:`ModelConfig` — architecture definition.
* :class:`QuantConfig` — W8A8 / W4A8 verification settings (the paper's technique).
* :class:`SpecConfig`  — speculative-decoding settings (drafting + verify).

The port so far runs the dense decoder over a contiguous KV cache; the
fields of the other families and the paged layout are kept for parity and
rejected where they would be read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (one per registered arch)."""

    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default: d_model // num_heads

    # --- MoE ----------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None
    dense_residual: bool = False
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) --------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128

    # --- hybrid (zamba2-style) -----------------------------------------
    attn_every: int = 0
    shared_attn: bool = False

    # --- VLM (llama-3.2-vision-style) ------------------------------------
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    # --- audio enc-dec (whisper-style) -----------------------------------
    encoder_layers: int = 0
    num_audio_frames: int = 0

    # --- attention / misc ------------------------------------------------
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu | gelu
    glu: bool = True
    attn_bias: bool = False
    ffn_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # "int8": KV cache stored int8 with per-(token, head) f32 scales folded
    # into the attention scores / probabilities.
    kv_cache_dtype: str = "bf16"
    # The port dispatches flash-eligible cache reads by device (kernel on
    # CUDA, plain version on the CPU); "auto" is the only value it takes.
    attn_impl: str = "auto"
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: ≤2 layers, d_model ≤ 512."""
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        while kv and heads % kv:
            kv -= 1
        hd = 32
        d = hd * max(heads, 4)
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=4 * d if self.d_ff else 0,
            moe_d_ff=2 * d if self.is_moe else None,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            moe_capacity_factor=float(min(self.num_experts, 4)) if self.is_moe else 1.25,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 128,
            attn_every=2 if self.attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            num_image_tokens=8 if self.num_image_tokens else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            num_audio_frames=16 if self.num_audio_frames else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            # f32 for smoke tests: with random-init weights the logit gaps
            # are tiny, and bf16 rounding can flip argmax — f32 keeps the
            # losslessness and parity tests deterministic.
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """W8A8 quantized-verification settings (paper §3.2-3.3); ``w_bits=4``
    packs int4 weights (W4A8)."""

    enabled: bool = True
    alpha: float = 0.5                  # SmoothQuant migration strength (Eq. 5)
    w_bits: int = 8
    a_bits: int = 8
    per_channel_weights: bool = True
    per_token_activations: bool = True
    quantize_embedding: bool = False
    calib_batches: int = 4
    calib_seq_len: int = 128
    use_pallas: bool = False            # reference-only: TPU kernel switch


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding settings (paper §3.1, §4.4)."""

    gamma: int = 5
    k_min: int = 1
    k_max: int = 4
    temperature: float = 0.0
    max_new_tokens: int = 64
    drafter: str = "ngram"              # registered: ngram | vanilla | pruned | ngram-tree
    verifier: str = "w8a8"              # registered: w8a8 | w4a8 | bf16
    pruned_retention: float = 0.75
    tree_branches: Optional[Tuple[int, ...]] = None
    kv_layout: str = "contiguous"       # the port serves "contiguous" only
    kv_block_size: int = 128
    kv_pool_blocks: Optional[int] = None
    kv_prefix_sharing: bool = True
    kv_preempt: bool = True
