"""Registered verifiers — port of ``repro/core/verifiers.py`` (``bf16`` and
``w8a8``; ``w4a8`` waits for the W4A8 slice).

All share the lossless accept rule; they differ in offline weight
preparation.  ``W8A8Verifier.prepare`` applies SmoothQuant + symmetric
INT8, so the memory-bound verification pass streams half the weight bytes
of bf16.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.config import QuantConfig, SpecConfig
from repro_torch.core.protocols import Verifier, register_verifier


@register_verifier("bf16")
class BF16Verifier(Verifier):
    """Full-precision verification: params pass through untouched."""


@register_verifier("w8a8")
class W8A8Verifier(Verifier):
    """Quantized verification (paper §3.2-3.3): ``prepare`` replaces every
    quantizable linear with its smoothed W8A8 form.  Idempotent.  Without
    ``act_stats`` smoothing is weight-only (s = 1)."""

    def __init__(self, qcfg: Optional[QuantConfig] = None):
        self.qcfg = qcfg if qcfg is not None else QuantConfig()

    @classmethod
    def from_config(cls, scfg: SpecConfig) -> "W8A8Verifier":
        return cls(QuantConfig())

    def prepare(self, model, params, act_stats=None):
        from repro_torch.quant.apply import quantize_params
        return quantize_params(params, act_stats, self.qcfg)
