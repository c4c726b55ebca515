"""Registered drafters — port of ``repro/core/drafters.py`` (``ngram`` and
``vanilla``; ``pruned`` and ``ngram-tree`` wait for later slices).

* ``ngram``   — prompt-lookup (PLD) self-drafting, the paper's strategy.
* ``vanilla`` — gamma=0: the decode step reduces to the autoregressive
  baseline (one token per forward).
"""
from __future__ import annotations

import torch

from repro_torch.core.config import SpecConfig
from repro_torch.core.drafting import draft_tokens
from repro_torch.core.protocols import DraftProposal, Drafter, register_drafter


@register_drafter("ngram")
class NgramDrafter(Drafter):
    """Prompt-lookup drafting (paper §4.1).  Deterministic, stateless and
    cache-free — drafting costs a token-buffer scan."""

    def __init__(self, gamma: int = 5, k_min: int = 1, k_max: int = 4):
        self.gamma = gamma
        self.k_min = k_min
        self.k_max = k_max

    @classmethod
    def from_config(cls, scfg: SpecConfig) -> "NgramDrafter":
        return cls(gamma=scfg.gamma, k_min=scfg.k_min, k_max=scfg.k_max)

    def propose(self, model, params, tokens, length, dstate, generators):
        drafts = draft_tokens(tokens, length, gamma=self.gamma,
                              k_min=self.k_min, k_max=self.k_max)
        return DraftProposal(tokens=drafts), dstate


@register_drafter("vanilla")
class VanillaDrafter(Drafter):
    """gamma=0: propose nothing; each step commits exactly one token."""

    gamma = 0

    def propose(self, model, params, tokens, length, dstate, generators):
        empty = torch.zeros((tokens.shape[0], 0), dtype=torch.int32, device=tokens.device)
        return DraftProposal(tokens=empty), dstate
