"""Speculative decode step: draft → verify → accept → commit — port of
``repro/core/spec_engine.py`` (the chain and token-tree routes).

:func:`make_decode_step` builds ``decode_step(params, state)`` from a
:class:`~repro_torch.core.protocols.Drafter` and a
:class:`~repro_torch.core.protocols.Verifier`.  Engine state is a dict:

  tokens         (B, S_buf) int32   committed text buffer
  length         (B,)       int32   committed token counts
  target         (B,)       int32   per-request stop lengths (optional):
                                    commits are masked so ``length`` never
                                    exceeds it
  cache          dict               verifier KV cache (covers [0, length-1))
  drafter_state  any                drafter-owned state ({} if stateless, the
                                    draft KV cache for ``pruned``)
  generators     list               one torch.Generator per row
  stats          {"commits": (B,), "steps": (), "row_steps": (B,),
                  "bad": (B,) bool}  acceptance bookkeeping, and the sticky
                                    per-row flag that the verifier produced
                                    non-finite logits for an active row

The KV cache is updated in place (``models/attention.write_cache``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def init_state(model, batch: int, buf_len: int, generators: Sequence[torch.Generator],
               drafter_state=None, target=None, cache=None) -> dict:
    dev = model.device
    state = {
        "tokens": torch.zeros((batch, buf_len), dtype=torch.int32, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "cache": cache if cache is not None else model.init_cache(batch, buf_len),
        "drafter_state": drafter_state if drafter_state is not None else {},
        "generators": list(generators),
        "stats": {
            "commits": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "steps": torch.zeros((), dtype=torch.int32, device=dev),
            # steps during which the row was still below its target — the
            # honest denominator for per-row acceptance length
            "row_steps": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "bad": torch.zeros((batch,), dtype=torch.bool, device=dev),
        },
    }
    if target is not None:
        state["target"] = torch.as_tensor(target, dtype=torch.int32, device=dev)
    return state


def _commit_tokens(tokens, length, drafts, next_token, n_accept, n_write=None):
    """Write [drafts[:n_accept], next_token] at per-row offsets; ``n_write``
    (default ``n_accept + 1``) caps how many are written (frozen rows)."""
    B, S = tokens.shape
    gamma = drafts.shape[1]
    if n_write is None:
        n_write = n_accept + 1
    i = torch.arange(gamma + 1, device=tokens.device)[None, :]
    vals = torch.cat([drafts, next_token[:, None]], dim=1)            # (B, γ+1)
    vals = torch.where(i == n_accept[:, None], next_token[:, None], vals)
    pos = (length[:, None] + i).clamp(0, S - 1)
    keep = i < n_write[:, None]
    cur = torch.gather(tokens, 1, pos)
    vals = torch.where(keep, vals, cur).to(tokens.dtype)
    return tokens.scatter(1, pos, vals)


def make_decode_step(model, drafter, verifier, scfg):
    """Build ``decode_step(params, state) -> state``; ``params`` must already
    be prepared (``verifier.prepare``)."""
    from repro_torch.core.protocols import get_drafter, get_verifier

    drafter = get_drafter(drafter, scfg)
    verifier = get_verifier(verifier, scfg)
    # a drafter with a template takes the token-tree route: the window is
    # the packed node tree (depth positions + ancestor mask), verification
    # walks the tree and the commit compacts the accepted path.  The chain
    # route is the single-branch tree, bit for bit.
    template = getattr(drafter, "template", None)
    if template is not None:
        if model.cfg.arch_type in ("ssm", "hybrid"):
            raise ValueError(
                f"tree speculation needs attention-family caches; "
                f"{model.cfg.arch_type!r} caches are recurrent")
        if model.cfg.sliding_window:
            raise ValueError(
                "tree speculation requires a contiguous KV cache; sliding-window "
                "(ring) caches cannot hold sibling nodes at one position")

    def decode_step(params, state):
        tokens, length = state["tokens"], state["length"]
        gens = state["generators"]
        proposal, dstate = drafter.propose(model, params, tokens, length,
                                           state["drafter_state"], gens)
        start = (length - 1).clamp(min=0)
        last = torch.gather(tokens, 1, start.long()[:, None])
        window = torch.cat([last, proposal.tokens], dim=1)            # (B, γ+1)
        if "target" in state:
            active_mask = length < state["target"]
        else:
            active_mask = torch.ones_like(length, dtype=torch.bool)

        if template is None:
            logits, cand = model.verify_step(params, state["cache"], window, start)
            res = verifier.verify(logits, proposal, scfg.temperature, gens)
        else:
            tables = template.on(window.device)
            logits, cand = model.verify_step(
                params, state["cache"], window, start, tree_depths=tables.depths,
                tree_mask=tables.mask, tree_bits=tables.mask_bits)
            res = verifier.verify_tree(logits, proposal, template, scfg.temperature, gens)
        # per-row losslessness tripwire: non-finite verifier logits on an
        # active row
        row_bad = ~torch.isfinite(logits).flatten(1).all(dim=1) & active_mask

        if template is None:
            cache = model.commit(cand, res.n_accept)
            drafts = proposal.tokens
        else:
            cache = model.commit_tree(cand, start, res.path_nodes, res.n_accept)
            drafts = res.path_tokens           # the accepted path, in chain order
        dstate = drafter.advance(model, dstate, proposal, res.n_accept)
        n_commit = res.n_commit
        if "target" in state:
            n_commit = torch.minimum(n_commit.clamp(min=0), state["target"] - length)
        tokens = _commit_tokens(tokens, length, drafts, res.next_token,
                                res.n_accept, n_write=n_commit)
        stats = state["stats"]
        out = {
            "tokens": tokens,
            "length": length + n_commit,
            "cache": cache,
            "drafter_state": dstate,
            "generators": gens,
            "stats": {
                "commits": stats["commits"] + n_commit,
                "steps": stats["steps"] + 1,
                "row_steps": stats["row_steps"] + active_mask.to(torch.int32),
                "bad": stats["bad"] | row_bad,
            },
        }
        if "target" in state:
            out["target"] = state["target"]
        return out

    return decode_step
