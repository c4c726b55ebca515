"""Model facade: the public API the engine and the launcher use — port of
``repro/models/model.py`` (canonical per-layer layout; the reference's
stacked "scan" layout exists to shrink XLA programs and has no eager
counterpart)."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import Transformer


def init_params(cfg, generator: torch.Generator, device="cuda") -> Transformer:
    """Seeded random weights with the reference's distributions
    (``models/common.py`` initializers); the generator must live on
    ``device``."""
    return Transformer.init(cfg, generator, resolve_device(device))


class Model:
    """Thin facade over the decoder stack for one ModelConfig on one device."""

    def __init__(self, cfg, device="cuda"):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, generator: torch.Generator) -> Transformer:
        return init_params(self.cfg, generator, self.device)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, self.device)

    # -- full forward (calibration / fidelity eval) -----------------------
    def forward(self, params: Transformer, tokens, *, collect=None):
        """Returns (logits (B,T,V) f32, aux loss 0) over positions 0..T-1."""
        start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        logits, _ = params(tokens, start, collect=collect)
        return logits, torch.zeros((), device=tokens.device)

    # -- serving ------------------------------------------------------------
    def prefill(self, params: Transformer, cache: dict, tokens) -> dict:
        """Process the prompt *except its last token* into the cache (the
        caller passes ``prompts[:, :-1]``); the last prompt token becomes
        the first token of the first verify window."""
        start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        _, cache = params(tokens, start, cache=cache, read_cache=False,
                          need_logits=False)
        return cache

    def verify_step(self, params: Transformer, cache: dict, window_tokens, start):
        """Forward a speculative window (B, T=γ+1) at per-row ``start``.
        Returns (logits, candidate cache); resolve with :meth:`commit`."""
        return params(window_tokens, start, cache=cache)

    def decode_step(self, params: Transformer, cache: dict, token, start):
        """Vanilla single-token decode: (B,1) → (logits (B,1,V), cache)."""
        return params(token, start, cache=cache)

    def commit(self, cache: dict, n_last) -> dict:
        return transformer.commit_cache(self.cfg, cache, n_last)
