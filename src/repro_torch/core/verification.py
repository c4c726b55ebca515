"""Lossless rejection-sampling verification (paper Eq. 2-3) — port of
``repro/core/verification.py`` (``verify`` and ``verify_tree``).

The verifier's logits define the target distribution p(·).  The
prompt-lookup drafter is deterministic (q is one-hot at the drafted
token), so Eq. 2 reduces to: accept x̃_i ⇔ r < p(x̃_i), r ~ U[0,1], and
the residual (Eq. 3) is norm(max(0, p - onehot(x̃_i))).  At T=0 both reduce
to exact-match against argmax p.

The random inputs — the acceptance uniforms and the Gumbel noise of the
corrective and bonus categorical draws — may be passed in; a test hands
the port exactly the noise JAX drew.  Otherwise each row draws its own
from its ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import prng


class VerifyResult(NamedTuple):
    n_accept: torch.Tensor      # (B,) int32 — accepted draft tokens ∈ [0, γ]
    next_token: torch.Tensor    # (B,) int32 — corrective / bonus token
    n_commit: torch.Tensor      # (B,) int32 — tokens committed = n_accept + 1


def _probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """(..., V) f32 target probabilities; T=0 → one-hot argmax."""
    if temperature == 0.0:
        idx = logits.argmax(dim=-1)
        return torch.nn.functional.one_hot(idx, logits.shape[-1]).float()
    return torch.softmax(logits.float() / temperature, dim=-1)


def _sample(probs: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    logp = torch.log(probs.clamp_min(1e-30))
    return prng.categorical_rows(logp, gumbel).to(torch.int32)


def _residual(p, q):
    """Eq. 3: norm(max(0, p - q)), falling back to p when numerically empty."""
    r = (p - q).clamp_min(0.0)
    rsum = r.sum(dim=-1, keepdim=True)
    return torch.where(rsum > 1e-9, r / rsum.clamp_min(1e-20), p)


def verify(
    logits: torch.Tensor,          # (B, γ+1, V) — logits[i] is p(· | window[:i+1])
    drafts: torch.Tensor,          # (B, γ) drafted tokens (window[1:])
    temperature: float,
    generators: Optional[Sequence[torch.Generator]] = None,
    draft_probs: Optional[torch.Tensor] = None,   # (B, γ, V) stochastic drafters
    *,
    uniforms: Optional[torch.Tensor] = None,      # (B, γ) acceptance draws
    gumbel_res: Optional[torch.Tensor] = None,    # (B, V) corrective-sample noise
    gumbel_bonus: Optional[torch.Tensor] = None,  # (B, V) bonus-sample noise
) -> VerifyResult:
    """Vectorized prefix rejection sampling.  At T > 0, noise not passed in
    is drawn from ``generators`` (one per row)."""
    B, g1, V = logits.shape
    gamma = g1 - 1
    dev = logits.device
    p = _probs(logits, temperature)                                    # (B, γ+1, V)

    def noise(given, draw):
        if given is not None:
            return given.to(dev)
        if generators is None:
            raise ValueError("verify at temperature > 0 needs generators or noise")
        return draw()

    if gamma == 0:
        if temperature == 0.0:
            next_token = p[:, 0].argmax(dim=-1).to(torch.int32)
        else:
            gb = noise(gumbel_bonus, lambda: prng.gumbel_rows(generators, V, dev))
            next_token = _sample(p[:, 0], gb)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        return VerifyResult(zero, next_token, zero + 1)

    d = drafts.long()
    p_draft = torch.gather(p[:, :gamma], 2, d[..., None])[..., 0]       # (B, γ)
    if draft_probs is None:
        ratio = p_draft                                                 # q = 1 at draft
    else:
        q_draft = torch.gather(draft_probs, 2, d[..., None])[..., 0]
        ratio = p_draft / q_draft.clamp_min(1e-20)

    if temperature == 0.0:
        # p is one-hot: ratio ∈ {0, 1} and r ∈ [0, 1) accepts exactly ratio 1
        accept = ratio >= 1.0
    else:
        r = noise(uniforms, lambda: prng.uniform_rows(generators, gamma, dev))
        accept = r < ratio.clamp(max=1.0)
    prefix_ok = torch.cumprod(accept.to(torch.int32), dim=1)
    n_accept = prefix_ok.sum(dim=1).to(torch.int32)                     # (B,)

    p_at = torch.gather(p, 1, n_accept.long()[:, None, None].expand(B, 1, V))[:, 0]
    if temperature == 0.0:
        next_token = p_at.argmax(dim=-1).to(torch.int32)
    else:
        pos = n_accept.clamp(max=gamma - 1).long()[:, None]
        if draft_probs is None:
            rej_tok = torch.gather(d, 1, pos)[:, 0]
            q_at = torch.nn.functional.one_hot(rej_tok, V).float()
        else:
            q_at = torch.gather(draft_probs, 1, pos[..., None].expand(B, 1, V))[:, 0]
        g_res = noise(gumbel_res, lambda: prng.gumbel_rows(generators, V, dev))
        g_bonus = noise(gumbel_bonus, lambda: prng.gumbel_rows(generators, V, dev))
        corrective = _sample(_residual(p_at, q_at), g_res)
        bonus = _sample(p_at, g_bonus)
        next_token = torch.where(n_accept == gamma, bonus, corrective)
    return VerifyResult(n_accept, next_token.to(torch.int32), n_accept + 1)


# ---------------------------------------------------------------------------
# Tree verification: longest accepted root-to-leaf path (SpecInfer-style)
# ---------------------------------------------------------------------------

class TreeVerifyResult(NamedTuple):
    n_accept: torch.Tensor      # (B,) int32 — accepted path depth ∈ [0, D]
    next_token: torch.Tensor    # (B,) int32 — corrective / bonus token
    n_commit: torch.Tensor      # (B,) int32 — tokens committed = n_accept + 1
    path_nodes: torch.Tensor    # (B, D+1) int32 — window-node ids of the
    #                             accepted path (col 0 = root); cols beyond
    #                             n_accept are 0-filled and must be masked
    path_tokens: torch.Tensor   # (B, D) int32 — tokens along the accepted
    #                             path in chain order (commit-ready drafts)


def verify_tree(
    logits: torch.Tensor,          # (B, N, V) — logits[i] = p(· | root→i path)
    drafts: torch.Tensor,          # (B, N-1) drafted tokens, packed node order
    template,                      # TreeTemplate (static topology)
    temperature: float,
    generators: Optional[Sequence[torch.Generator]] = None,
    draft_probs: Optional[torch.Tensor] = None,   # (B, N-1, V) stochastic q
    *,
    uniforms: Optional[torch.Tensor] = None,      # (B, D·max_branch) acceptance draws
    gumbel_res: Optional[torch.Tensor] = None,    # (B, V) corrective-sample noise
    gumbel_bonus: Optional[torch.Tensor] = None,  # (B, V) bonus-sample noise
) -> TreeVerifyResult:
    """Lossless rejection sampling down a token tree (Eq. 2-3 per branch).

    Walks the template level by level; at each level the current node's
    children are tested in packed order against the running target
    ``p_cur`` (Eq. 2 ratio p/q).  A rejection folds the rejected child's q
    out of ``p_cur`` (Eq. 3 residual) before the next sibling is tested;
    if no child is accepted the corrective token is sampled from the final
    residual, and a fully accepted path earns the leaf's bonus token.  At
    T = 0 this is exact match down the tree.

    Chain parity: for the single-branch template the rows draw the same
    noise, in the same order and shapes, as :func:`verify` (γ uniforms,
    then the corrective and the bonus Gumbel rows), so chain-as-tree
    reproduces the chain step exactly.
    """
    B, N, V = logits.shape
    D, mb = template.max_depth, template.max_branch
    dev = logits.device
    p_all = _probs(logits, temperature)                                # (B, N, V)

    def noise(given, draw):
        if given is not None:
            return given.to(dev)
        if generators is None:
            raise ValueError("verify_tree at temperature > 0 needs generators or noise")
        return draw()

    if N == 1:
        # root-only template: the chain's gamma == 0 branch
        if temperature == 0.0:
            next_token = p_all[:, 0].argmax(dim=-1).to(torch.int32)
        else:
            gb = noise(gumbel_bonus, lambda: prng.gumbel_rows(generators, V, dev))
            next_token = _sample(p_all[:, 0], gb)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        return TreeVerifyResult(zero, next_token, zero + 1,
                                torch.zeros((B, 1), dtype=torch.int32, device=dev),
                                torch.zeros((B, 0), dtype=torch.int32, device=dev))

    children = template.on(dev).children                               # (N, mb)
    if temperature != 0.0:
        u = noise(uniforms, lambda: prng.uniform_rows(generators, D * mb, dev))
        u = u.reshape(B, D, mb)
    d64 = drafts.long()
    cur = torch.zeros(B, dtype=torch.int64, device=dev)   # node the walk sits on
    p_cur = p_all[:, 0]                                   # target dist at `cur`
    done = torch.zeros(B, dtype=torch.bool, device=dev)   # a level rejected all
    n_accept = torch.zeros(B, dtype=torch.int32, device=dev)
    node_cols, tok_cols = [], []

    for d in range(1, D + 1):
        ch_row = children[cur]                                         # (B, mb)
        accepted = torch.zeros(B, dtype=torch.bool, device=dev)
        new_cur = cur
        for s in range(mb):
            child = ch_row[:, s]
            has = child >= 0
            cidx = child.clamp(1, N - 1)
            tok = torch.gather(d64, 1, (cidx - 1)[:, None])[:, 0]
            p_tok = torch.gather(p_cur, 1, tok[:, None])[:, 0]
            if draft_probs is None:
                ratio, q_dist = p_tok, None               # q is one-hot at the draft
            else:
                q_dist = torch.gather(draft_probs, 1,
                                      (cidx - 1)[:, None, None].expand(B, 1, V))[:, 0]
                q_tok = torch.gather(q_dist, 1, tok[:, None])[:, 0]
                ratio = p_tok / q_tok.clamp_min(1e-20)
            tested = ~done & ~accepted & has
            if temperature == 0.0:
                # p is one-hot: u ∈ [0, 1) accepts exactly ratio 1
                ok = tested & (ratio >= 1.0)
            else:
                ok = tested & (u[:, d - 1, s] < ratio.clamp(max=1.0))
                # fold the rejected sibling's q out of the running target
                # (Eq. 3); at T = 0 it is a no-op and skipped (chain parity)
                q_at = (torch.nn.functional.one_hot(tok, V).float()
                        if q_dist is None else q_dist)
                p_cur = torch.where((tested & ~ok)[:, None], _residual(p_cur, q_at), p_cur)
            new_cur = torch.where(ok, cidx, new_cur)
            accepted = accepted | ok
        # rows that accepted a child descend: p_cur ← p(· | path to child)
        p_next = torch.gather(p_all, 1, new_cur[:, None, None].expand(B, 1, V))[:, 0]
        p_cur = torch.where(accepted[:, None], p_next, p_cur)
        n_accept = n_accept + accepted.to(torch.int32)
        done = done | ~accepted
        cur = new_cur
        node_cols.append(torch.where(accepted, new_cur, 0))
        tok_new = torch.gather(d64, 1, (new_cur - 1).clamp(0, N - 2)[:, None])[:, 0]
        tok_cols.append(torch.where(accepted, tok_new, 0))

    if temperature == 0.0:
        next_token = p_cur.argmax(dim=-1).to(torch.int32)
    else:
        # p_cur is the residual for rejected rows
        g_res = noise(gumbel_res, lambda: prng.gumbel_rows(generators, V, dev))
        g_bonus = noise(gumbel_bonus, lambda: prng.gumbel_rows(generators, V, dev))
        corrective = _sample(p_cur, g_res)
        p_bonus = torch.gather(p_all, 1, cur[:, None, None].expand(B, 1, V))[:, 0]
        bonus = _sample(p_bonus, g_bonus)
        next_token = torch.where(n_accept == D, bonus, corrective).to(torch.int32)

    path_nodes = torch.stack([torch.zeros_like(cur)] + node_cols, dim=1).to(torch.int32)
    path_tokens = torch.stack(tok_cols, dim=1).to(torch.int32)
    return TreeVerifyResult(n_accept, next_token, n_accept + 1, path_nodes, path_tokens)
