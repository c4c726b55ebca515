"""Sampling utility — port of ``repro/serving/sampling.py``.

The reference draws from a ``jax.random`` key; the port draws from a
``torch.Generator`` (one per request stream, ``core/prng.py``) with the
same rule as ``jax.random.categorical``: the argmax of the logits plus
Gumbel noise.
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import gumbel_rows


def sample(generator: torch.Generator, logits: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """(..., V) logits → int32 token ids.  T = 0 ⇒ greedy (no draw)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    flat = logits.float().reshape(-1, logits.shape[-1]) / temperature
    g = gumbel_rows([generator], flat.numel(), flat.device).reshape(flat.shape)
    return torch.argmax(flat + g, dim=-1).reshape(logits.shape[:-1]).to(torch.int32)
