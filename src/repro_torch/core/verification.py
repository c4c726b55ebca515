"""Lossless rejection-sampling verification (paper Eq. 2-3) — port of
``repro/core/verification.py:verify``.

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
