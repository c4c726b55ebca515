"""Batched speculative serving engine — port of the homogeneous-batch path
of ``repro/serving/engine.py`` (``SpecEngine.generate``; continuous
batching waits for a later slice).

    engine = SpecEngine(model, SpecConfig(verifier="w8a8"))   # Quasar
    result = engine.generate(params, prompts, max_new_tokens=64)

The verifier owns offline weight preparation: with ``verifier="w8a8"``
the engine quantizes the params (SmoothQuant + INT8) on first use.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.core import prng
from repro_torch.core.config import SpecConfig
from repro_torch.core.protocols import get_drafter, get_verifier
from repro_torch.core.spec_engine import init_state, make_decode_step


@dataclass
class GenResult:
    tokens: torch.Tensor         # (B, S_buf) full buffers
    lengths: torch.Tensor        # (B,)
    mean_accept_len: float       # L — committed tokens per verify step
    steps: int                   # verify steps taken
    wall_s: float                # decode loop, prefill excluded
    new_tokens: int
    bad: torch.Tensor            # (B,) bool — non-finite verifier logits seen
    prefill_s: float = 0.0       # cache allocation + prompt prefill

    @property
    def tokens_per_s(self) -> float:
        return self.new_tokens / self.wall_s if self.wall_s > 0 else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SpecEngine:
    """Drafter × Verifier serving engine."""

    def __init__(self, model, scfg: SpecConfig = SpecConfig(), *,
                 drafter=None, verifier=None):
        if scfg.kv_layout != "contiguous":
            raise NotImplementedError("the port serves the contiguous KV layout only")
        self.model = model
        self.scfg = scfg
        self.drafter = get_drafter(drafter if drafter is not None else scfg.drafter, scfg)
        self.verifier = get_verifier(
            verifier if verifier is not None else scfg.verifier, scfg)
        self._step = make_decode_step(model, self.drafter, self.verifier, scfg)
        self._prepared = None                      # (params ref, prepared)

    def prepare_params(self, params, act_stats=None):
        """Offline weight preparation for this engine's verifier.  Idempotent."""
        return self.verifier.prepare(self.model, params, act_stats)

    def _prepare_cached(self, params):
        # keeps a reference to the last input tree as the cache key, so a
        # w8a8 engine pins the bf16 original while alive; memory-sensitive
        # callers prepare once and pass the prepared tree (idempotent)
        if self._prepared is not None and (
                params is self._prepared[0] or params is self._prepared[1]):
            return self._prepared[1]
        self._prepared = (params, self.prepare_params(params))
        return self._prepared[1]

    def _init_state(self, params, prompts, lengths, targets, buf, generators,
                    draft_params=None):
        """Prefill + assemble the decode-loop state."""
        B, P = prompts.shape
        if P < 2:
            raise ValueError("prompts must have >= 2 tokens")
        state = init_state(self.model, B, buf, generators, target=targets)
        state["tokens"][:, :P] = prompts
        state["length"] = torch.as_tensor(lengths, dtype=torch.int32,
                                          device=self.model.device)
        # the cache covers committed tokens except the last, which is the
        # first token of the first verify window
        state["cache"] = self.model.prefill(params, state["cache"], prompts[:, :-1])
        state["drafter_state"] = self.drafter.init_state(
            self.model, params, prompts, buf, draft_params=draft_params)
        return state

    def _run(self, params, state, max_steps: int):
        """Step until every row reaches its target (one host read of the
        lengths per step).  Returns (state, wall seconds)."""
        dev = self.model.device
        targets = state["target"].cpu()
        _sync(dev)
        t0 = time.perf_counter()
        steps = 0
        while True:
            state = self._step(params, state)
            steps += 1
            if bool((state["length"].cpu() >= targets).all()) or steps > max_steps:
                break
        _sync(dev)
        return state, time.perf_counter() - t0

    @torch.inference_mode()
    def generate(self, params, prompts: torch.Tensor,
                 max_new_tokens: Optional[int] = None, *,
                 generators: Optional[Sequence[torch.Generator]] = None,
                 seed: int = 0, draft_params=None) -> GenResult:
        """Homogeneous batch: prompts (B, P) int32 on the model's device,
        shared budget.  ``generators`` (one per row) default to request
        streams seeded ``seed, seed+1, …``.  ``draft_params``: separate
        weights for the pruned drafter's prefill (default: the prepared
        verifier weights, as in the reference)."""
        max_new = max_new_tokens or self.scfg.max_new_tokens
        dev = self.model.device
        prompts = prompts.to(device=dev, dtype=torch.int32)
        B, P = prompts.shape
        buf = P + max_new + self.drafter.gamma + 2
        if generators is None:
            generators = prng.row_generators(range(seed, seed + B), dev)

        params = self._prepare_cached(params)
        lengths = torch.full((B,), P, dtype=torch.int32, device=dev)
        targets = torch.full((B,), P + max_new, dtype=torch.int32, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        state = self._init_state(params, prompts, lengths, targets, buf, generators,
                                 draft_params)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        state, wall = self._run(params, state, max_new * 2 + 8)

        stats = state["stats"]
        L = float((stats["commits"] / stats["row_steps"].clamp(min=1)).mean())
        new_tokens = int((state["length"].clamp(max=P + max_new) - P).sum())
        return GenResult(tokens=state["tokens"], lengths=state["length"],
                         mean_accept_len=L, steps=int(stats["steps"]),
                         wall_s=wall, new_tokens=new_tokens, bad=stats["bad"],
                         prefill_s=prefill_s)
