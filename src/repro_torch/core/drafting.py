"""Prompt-lookup (n-gram) self-speculative drafting — port of
``repro/core/drafting.py`` (``draft_tokens`` and ``draft_tree_tokens``).

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


def _match_k_top(tokens, length, k: int, m: int):
    """The ``m`` most recent trailing-k-gram occurrences (tree drafting):
    (found (B,) bool, starts (B, m) — index after each match, most recent
    first, valid (B, m) bool); missing matches are trailing invalid slots."""
    valid = _match_valid(tokens, length, k)
    j = torch.arange(valid.shape[1], device=tokens.device)[None, :]
    scored = torch.where(valid, j, -1)
    top = scored.topk(min(m, valid.shape[1]), dim=1).values           # (B, ≤m)
    if top.shape[1] < m:
        top = torch.nn.functional.pad(top, (0, m - top.shape[1]), value=-1)
    return valid.any(dim=1), top + k, top >= 0


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


def draft_tree_tokens(tokens: torch.Tensor, length: torch.Tensor, template, *,
                      k_min: int = 1, k_max: int = 4) -> torch.Tensor:
    """Populate a token-tree template from the most recent prompt-lookup
    matches → (B, N-1) int32 drafts in packed node order (root excluded).

    As :func:`draft_tokens`, the longest matching k wins.  Matches whose
    first continuation token repeats a more recent match's are stably
    pushed back, so the root's children cover distinct continuations;
    match ``m``'s continuation fills the template's ``m``-th root-to-leaf
    path (a node at depth ``d`` takes token ``d-1`` of its representative
    leaf's continuation).  Child 0 of the root carries the chain drafter's
    proposal; rows with fewer matches than leaves reuse the most recent.
    """
    B, S = tokens.shape
    dev = tokens.device
    M, D = template.num_leaves, template.max_depth
    if D == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)

    M2 = M + 8 if M > 1 else M     # extra candidates for the dedupe pass
    starts = torch.zeros((B, M2), dtype=torch.int64, device=dev)
    svalid = torch.zeros((B, M2), dtype=torch.bool, device=dev)
    found_any = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(k_min, k_max + 1):        # longer k overwrite shorter ones
        found, st, v = _match_k_top(tokens, length, k, M2)
        starts = torch.where(found[:, None], st, starts)
        svalid = torch.where(found[:, None], v, svalid)
        found_any = found_any | found

    # slots beyond the row's match count reuse the most recent match
    starts = torch.where(svalid, starts, starts[:, :1])
    if M2 > M:
        tok0 = torch.gather(tokens, 1, starts.clamp(0, S - 1))        # (B, M2)
        i = torch.arange(M2, device=dev)
        dup = ((tok0[:, :, None] == tok0[:, None, :])
               & (i[None, :] < i[:, None])[None]).any(dim=2)            # (B, M2)
        order = torch.argsort(dup.long() * M2 + i[None, :], dim=1)
        starts = torch.gather(starts, 1, order[:, :M])

    idx = starts[:, :, None] + torch.arange(D, device=dev)[None, None, :]   # (B, M, D)
    last = torch.gather(tokens, 1, (length - 1).clamp(min=0).long()[:, None])
    in_text = (idx < length[:, None, None]) & found_any[:, None, None]
    flat = torch.gather(tokens, 1, idx.clamp(0, S - 1).reshape(B, M * D)).reshape(B, M, D)
    cont = torch.where(in_text, flat, last[:, :, None])

    tables = template.on(dev)
    return cont[:, tables.src_leaf[1:], tables.depths[1:].long() - 1].to(torch.int32)
