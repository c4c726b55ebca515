"""Registered drafters — port of ``repro/core/drafters.py``.

* ``ngram``      — prompt-lookup (PLD) self-drafting, the paper's strategy.
* ``vanilla``    — gamma=0: the decode step reduces to the autoregressive
  baseline (one token per forward).
* ``pruned``     — Table-5 baseline: the first ``retention * L`` layers of
  the target model draft gamma tokens autoregressively (stochastic q at
  T>0).
* ``ngram-tree`` — token-tree prompt lookup: a static
  :class:`~repro_torch.core.tree.TreeTemplate` filled from the most recent
  n-gram matches, verified down the tree.

:class:`ChainTreeAdapter` runs any chain drafter through the tree route as
the degenerate single-branch tree, which must give the chain route's
tokens bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.config import SpecConfig
from repro_torch.core.drafting import draft_tokens, draft_tree_tokens
from repro_torch.core.protocols import DraftProposal, Drafter, register_drafter
from repro_torch.core.tree import TreeTemplate


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


def _with_tree(proposal: DraftProposal, template: TreeTemplate, device) -> DraftProposal:
    tables = template.on(device)
    return proposal._replace(parents=tables.parents, tree_mask=tables.mask)


@register_drafter("ngram-tree")
class NgramTreeDrafter(Drafter):
    """Token-tree prompt-lookup drafting: one verifier pass scores
    ``num_leaves`` candidate continuations instead of one.  Deterministic,
    stateless, cache-free; exposes ``template``, the topology the decode
    step builds its tree route from."""

    def __init__(self, template: TreeTemplate | None = None, *,
                 gamma: int = 5, k_min: int = 1, k_max: int = 4):
        self.template = template if template is not None else TreeTemplate.chain(gamma)
        self.gamma = self.template.gamma
        self.k_min = k_min
        self.k_max = k_max

    @classmethod
    def from_config(cls, scfg: SpecConfig) -> "NgramTreeDrafter":
        tpl = (TreeTemplate(scfg.tree_branches) if scfg.tree_branches
               else TreeTemplate.chain(scfg.gamma))
        return cls(tpl, k_min=scfg.k_min, k_max=scfg.k_max)

    def propose(self, model, params, tokens, length, dstate, generators):
        drafts = draft_tree_tokens(tokens, length, self.template,
                                   k_min=self.k_min, k_max=self.k_max)
        return _with_tree(DraftProposal(tokens=drafts), self.template, tokens.device), dstate


class ChainTreeAdapter(Drafter):
    """Run any chain drafter through the tree route (depth positions,
    ancestor mask, path commit, tree rejection sampling) as the degenerate
    single-branch tree, delegating every lifecycle hook."""

    name = "chain-tree"

    def __init__(self, base: Drafter):
        self.base = base
        self.gamma = base.gamma
        self.template = TreeTemplate.chain(base.gamma)

    def with_temperature(self, temperature: float) -> "ChainTreeAdapter":
        return ChainTreeAdapter(self.base.with_temperature(temperature))

    def init_state(self, model, params, prompts, buf_len, *, draft_params=None):
        return self.base.init_state(model, params, prompts, buf_len,
                                    draft_params=draft_params)

    def alloc_state(self, model, params, batch, buf_len, *, draft_params=None):
        return self.base.alloc_state(model, params, batch, buf_len,
                                     draft_params=draft_params)

    def propose(self, model, params, tokens, length, dstate, generators):
        proposal, dstate = self.base.propose(model, params, tokens, length, dstate,
                                             generators)
        return _with_tree(proposal, self.template, tokens.device), dstate

    def advance(self, model, dstate, proposal, n_accept):
        return self.base.advance(model, dstate, proposal, n_accept)


@register_drafter("vanilla")
class VanillaDrafter(Drafter):
    """gamma=0: propose nothing; each step commits exactly one token."""

    gamma = 0

    def propose(self, model, params, tokens, length, dstate, generators):
        empty = torch.zeros((tokens.shape[0], 0), dtype=torch.int32, device=tokens.device)
        return DraftProposal(tokens=empty), dstate


@register_drafter("pruned")
class PrunedDrafter(Drafter):
    """Structurally pruned self-drafting (paper Table 5): the first
    ``retention * L`` layers draft gamma tokens autoregressively against
    their own KV cache (the drafter state, updated in place); the full
    model verifies.  At T > 0 each row draws its tokens from its own
    generator, and ``probs`` carries the draft distribution q for the full
    Eq. 2 ratio."""

    def __init__(self, gamma: int = 5, retention: float = 0.75,
                 temperature: float = 0.0):
        self.gamma = gamma
        self.retention = retention
        self.temperature = temperature

    @classmethod
    def from_config(cls, scfg: SpecConfig) -> "PrunedDrafter":
        return cls(gamma=scfg.gamma, retention=scfg.pruned_retention,
                   temperature=scfg.temperature)

    def with_temperature(self, temperature: float) -> "PrunedDrafter":
        return PrunedDrafter(gamma=self.gamma, retention=self.retention,
                             temperature=temperature)

    def n_keep(self, model) -> int:
        return max(1, int(round(model.cfg.num_layers * self.retention)))

    def init_state(self, model, params, prompts, buf_len: int, *, draft_params=None):
        n_keep = self.n_keep(model)
        pcache = model.init_cache(prompts.shape[0], buf_len, num_layers=n_keep)
        return model.prefill(draft_params if draft_params is not None else params,
                             pcache, prompts[:, :-1], num_layers=n_keep)

    def alloc_state(self, model, params, batch: int, buf_len: int, *, draft_params=None):
        # an empty (un-prefilled) draft cache
        return model.init_cache(batch, buf_len, num_layers=self.n_keep(model))

    def propose(self, model, params, tokens, length, dstate, generators):
        n_keep = self.n_keep(model)
        pcache = dstate
        pos = (length - 1).clamp(min=0)
        tok = torch.gather(tokens, 1, pos.long()[:, None])
        drafts, qprobs = [], []
        for i in range(self.gamma):
            logits, pcache = model.decode_step(params, pcache, tok, pos + i,
                                               num_layers=n_keep)
            lf = logits[:, -1].float()
            if self.temperature == 0.0:
                nxt = lf.argmax(dim=-1).to(torch.int32)
                qprobs.append(torch.nn.functional.one_hot(nxt.long(), lf.shape[-1]).float())
            else:
                q = torch.softmax(lf / self.temperature, dim=-1)
                logq = torch.log(q.clamp_min(1e-30))
                gumbel = prng.gumbel_rows(generators, lf.shape[-1], lf.device)
                nxt = prng.categorical_rows(logq, gumbel).to(torch.int32)
                qprobs.append(q)
            drafts.append(nxt)
            tok = nxt[:, None]
        proposal = DraftProposal(tokens=torch.stack(drafts, dim=1),      # (B, gamma)
                                 probs=torch.stack(qprobs, dim=1))      # (B, gamma, V)
        return proposal, pcache
