"""Pluggable decoding protocols: ``Drafter`` and ``Verifier`` — port of
``repro/core/protocols.py`` (chain and token-tree proposals, and the
continuous-batching slot lifecycle).

``Drafter``:

* ``init_state(model, params, prompts, buf_len, *, draft_params=None)`` →
  drafter state (once per generation; ``{}`` for stateless drafters, a
  prefilled draft cache for ``pruned``); ``alloc_state`` allocates it
  empty for a scheduler group, and ``prefill_row`` resets one slot of it
  for a newly admitted request, in place;
* ``propose(model, params, tokens, length, dstate, generators)`` →
  ``(DraftProposal, dstate)`` every step.  ``proposal.tokens`` is
  ``(B, gamma)`` int32; ``probs`` is ``None`` for deterministic drafters
  (one-hot q) or ``(B, gamma, V)`` f32.  Random numbers come from the
  per-row ``generators`` (stateful, so nothing is threaded back);
* ``advance(model, dstate, proposal, n_accept)`` → drafter state.

``Verifier``:

* ``prepare(model, params, act_stats=None)`` → params: offline weight
  preparation, idempotent (``w8a8`` applies SmoothQuant + INT8 here);
* ``verify(logits, proposal, temperature, generators)`` →
  ``VerifyResult``: the lossless accept rule (Eq. 2-3);
* ``verify_tree(logits, proposal, template, temperature, generators)`` →
  ``TreeVerifyResult``: the same rule down a token tree.

Implementations self-register by name and are built from a ``SpecConfig``
with ``get_drafter`` / ``get_verifier``; an instance passes through.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Type

import torch

from repro_torch.core.config import SpecConfig
from repro_torch.core.verification import (TreeVerifyResult, VerifyResult,
                                           verify, verify_tree)


class DraftProposal(NamedTuple):
    """Fixed-shape drafting output: the drafter→verifier contract."""

    tokens: torch.Tensor                  # (B, gamma) int32 drafted tokens
    probs: Optional[torch.Tensor] = None  # (B, gamma, V) f32 draft dist q, or
    #                                       None for deterministic drafters
    parents: Optional[torch.Tensor] = None    # (N,) int32 window-parent
    #                                           pointers, -1 at the root
    tree_mask: Optional[torch.Tensor] = None  # (N, N) bool ancestor-or-self
    #                                           mask over the packed window


class Drafter:
    """Base drafting strategy.  Subclass + register."""

    name: str = "base"
    gamma: int = 0

    @classmethod
    def from_config(cls, scfg: SpecConfig) -> "Drafter":
        return cls()

    def with_temperature(self, temperature: float) -> "Drafter":
        """A drafter for another sampling temperature (self, unless the
        drafter samples while it proposes)."""
        return self

    def init_state(self, model, params, prompts, buf_len: int, *,
                   draft_params=None) -> Any:
        return {}

    def alloc_state(self, model, params, batch: int, buf_len: int, *,
                    draft_params=None) -> Any:
        """An **empty** ``batch``-row drafter state for a scheduler group
        (every tensor batch-leading, zeroed); ``{}`` for stateless
        drafters."""
        return {}

    def prefill_row(self, model, params, dstate, row: int, prompt, buf_len: int, *,
                    draft_params=None) -> Any:
        """Reset slot ``row`` of ``dstate`` for a newly admitted request, in
        place, and return ``dstate``.  ``prompt`` is ``(1, P)`` int32, the
        **unpadded** prompt: a draft-side cache may keep slots the drafter
        never rewrites, and a solo run has zeros there.  A no-op for
        stateless drafters."""
        return dstate

    def propose(self, model, params, tokens, length, dstate, generators):
        raise NotImplementedError

    def advance(self, model, dstate, proposal: DraftProposal, n_accept):
        return dstate


class Verifier:
    """Base verification strategy: lossless rejection sampling over the
    target model's logits, plus offline weight preparation."""

    name: str = "base"

    @classmethod
    def from_config(cls, scfg: SpecConfig) -> "Verifier":
        return cls()

    def prepare(self, model, params, act_stats=None):
        return params

    def verify(self, logits, proposal: DraftProposal, temperature: float,
               generators) -> VerifyResult:
        return verify(logits, proposal.tokens, temperature, generators,
                      draft_probs=proposal.probs)

    def verify_tree(self, logits, proposal: DraftProposal, template,
                    temperature: float, generators) -> TreeVerifyResult:
        return verify_tree(logits, proposal.tokens, template, temperature,
                           generators, draft_probs=proposal.probs)


_DRAFTERS: Dict[str, Type[Drafter]] = {}
_VERIFIERS: Dict[str, Type[Verifier]] = {}


def register_drafter(name: str):
    def deco(cls: Type[Drafter]):
        cls.name = name
        _DRAFTERS[name] = cls
        return cls
    return deco


def register_verifier(name: str):
    def deco(cls: Type[Verifier]):
        cls.name = name
        _VERIFIERS[name] = cls
        return cls
    return deco


def _load_registered() -> None:
    # the implementations register themselves on import
    from repro_torch.core import drafters, verifiers  # noqa: F401


def available_drafters() -> tuple:
    _load_registered()
    return tuple(sorted(_DRAFTERS))


def available_verifiers() -> tuple:
    _load_registered()
    return tuple(sorted(_VERIFIERS))


def get_drafter(spec, scfg: Optional[SpecConfig] = None) -> Drafter:
    """Resolve a drafter: instance passthrough, or registry name lookup."""
    if isinstance(spec, Drafter):
        return spec
    _load_registered()
    if spec not in _DRAFTERS:
        raise ValueError(f"unknown drafter {spec!r}; registered: {available_drafters()}")
    return _DRAFTERS[spec].from_config(scfg if scfg is not None else SpecConfig())


def get_verifier(spec, scfg: Optional[SpecConfig] = None) -> Verifier:
    """Resolve a verifier: instance passthrough, or registry name lookup."""
    if isinstance(spec, Verifier):
        return spec
    _load_registered()
    if spec not in _VERIFIERS:
        raise ValueError(f"unknown verifier {spec!r}; registered: {available_verifiers()}")
    return _VERIFIERS[spec].from_config(scfg if scfg is not None else SpecConfig())
