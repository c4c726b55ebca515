"""Prompt-lookup (n-gram) self-speculative drafting — port of
``repro/core/drafting.py:draft_tokens``.

Match the trailing k-gram of the committed text against the text itself
and propose the γ tokens that followed the most recent match; the longest
k in [k_min, k_max] with a match wins (paper §4.1).  With no match, the
drafts repeat the last token.  Vectorized over the batch.
"""
from __future__ import annotations

import torch


def _match_valid(tokens: torch.Tensor, length: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S-k+1) bool: position j starts an occurrence of the trailing
    k-gram strictly before the trailing gram itself."""
    B, S = tokens.shape
    tail_idx = length[:, None] - k + torch.arange(k, device=tokens.device)[None, :]
    tail = torch.gather(tokens, 1, tail_idx.clamp(min=0).long())         # (B, k)
    win = tokens.unfold(1, k, 1)                                          # (B, S-k+1, k)
    eq = (win == tail[:, None, :]).all(dim=-1)
    j = torch.arange(S - k + 1, device=tokens.device)[None, :]
    return eq & (j < (length[:, None] - k)) & (length[:, None] >= 2 * k)


def _match_k(tokens, length, k: int):
    """Most recent occurrence: (found (B,) bool, start (B,) — index after it)."""
    valid = _match_valid(tokens, length, k)
    j = torch.arange(valid.shape[1], device=tokens.device)[None, :]
    best = torch.where(valid, j, -1).argmax(dim=1)
    return valid.any(dim=1), best + k


def draft_tokens(tokens: torch.Tensor, length: torch.Tensor, *, gamma: int,
                 k_min: int = 1, k_max: int = 4) -> torch.Tensor:
    """tokens (B, S) committed buffer, length (B,) → (B, γ) int32 drafts."""
    B, S = tokens.shape
    dev = tokens.device
    start = torch.zeros(B, dtype=torch.int64, device=dev)
    found_any = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(k_min, k_max + 1):        # longer k overwrite shorter ones
        found, st = _match_k(tokens, length, k)
        start = torch.where(found, st, start)
        found_any = found_any | found
    idx = start[:, None] + torch.arange(gamma, device=dev)[None, :]
    last = torch.gather(tokens, 1, (length - 1).clamp(min=0).long()[:, None])
    in_text = (idx < length[:, None]) & found_any[:, None]
    drafts = torch.gather(tokens, 1, idx.clamp(0, S - 1))
    return torch.where(in_text, drafts, last).to(torch.int32)
