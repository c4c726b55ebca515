"""Request-level serving types: per-request prompts, budgets, and results —
port of ``repro/serving/request.py`` (host-only numpy, copied).

``SpecEngine.generate_requests`` serves a list of
:class:`GenerationRequest` with heterogeneous prompt lengths,
``max_new_tokens``, seeds and temperatures through the continuous-batching
scheduler (:class:`repro_torch.serving.scheduler.Scheduler`):

* a fixed number of batch *slots* steps in one fixed-shape decode loop;
  prompts are right-padded to the serving group's maximum (padding junk
  beyond a row's committed length is never attended — verify windows
  overwrite positions before the causal frontier reaches them);
* a per-row ``target`` slot in the engine state masks commits, so a row
  that exhausts its budget freezes exactly there; the scheduler harvests
  it and admits the next pending request into the freed slot
  (prefill-into-slot — no recompilation, the decode step stays
  fixed-shape);
* each request's ``seed`` derives a per-row PRNG stream
  (``repro_torch.core.prng.request_generator``), so generated tokens are invariant to
  batch composition, admission order and slot placement;
* requests with different temperatures are grouped and scheduled per
  group (temperature is a constant of the decode step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def safe_rate(count: int, seconds: float) -> float:
    """``count / seconds`` guarded against zero/negative time.

    Fast CPU runs (and synthetic test loops) can legitimately record a
    0.0 wall/service time; a rate of 0.0 is the honest answer there —
    not a division crash, and not the absurd ``count / 1e-9`` spike.
    """
    return float(count) / seconds if seconds > 0.0 else 0.0


@dataclass
class GenerationRequest:
    """One decode request.

    ``temperature=None`` inherits the engine's ``SpecConfig.temperature``.
    ``seed`` derives the request's own PRNG stream: the generated tokens
    depend only on (prompt, seed, temperature, params), never on which
    other requests happened to share the batch.
    ``priority`` orders *admission* (lower = more urgent; FIFO within a
    priority class) — it shifts ``queue_s``, never the generated tokens.
    ``deadline_s`` is the request's SLO: seconds from *submission* by
    which the full generation should complete.  Under ``admission="edf"``
    pending requests are ordered earliest-deadline-first within their
    priority class, and the serving front-end
    (the reference's ``serving/server.py``, not ported yet) may shed a
    request whose deadline passed
    while it was still queued.  Like ``priority`` it only reorders
    admission — never the generated tokens.
    """

    prompt: np.ndarray                  # (P,) int32 token ids, P >= 2
    max_new_tokens: int = 64
    temperature: Optional[float] = None
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 2:
            raise ValueError("prompt must have >= 2 tokens")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and not self.deadline_s > 0.0:
            raise ValueError("deadline_s must be positive (or None)")

    def violation(self, max_prompt_len: int,
                  max_new_tokens: int) -> Optional[str]:
        """Why this request cannot be served under the given server caps
        (None if it can).  The serving front-end rejects a violating
        request as terminally ``failed`` instead of raising into the
        caller — one bad request never takes down the submit path
        (docs/robustness.md)."""
        if self.prompt.size > max_prompt_len:
            return (f"prompt length {self.prompt.size} exceeds the "
                    f"server's max_prompt_len={max_prompt_len}")
        if self.max_new_tokens > max_new_tokens:
            return (f"max_new_tokens {self.max_new_tokens} exceeds the "
                    f"server's cap {max_new_tokens}")
        return None


@dataclass
class RequestResult:
    """Per-request generation output (all fields are request-level)."""

    request: GenerationRequest
    tokens: np.ndarray                  # (max_new_tokens,) int32 new tokens
    prompt_len: int
    accept_len: float                   # committed tokens per verify step
    #                                     while this request occupied a slot
    steps: int                          # verify steps this request was
    #                                     actively decoding for
    queue_s: float                      # time spent waiting for a slot
    service_s: float                    # time from slot admission to the
    #                                     step that completed the request
    bad: bool = False                   # the port's addition: the verifier
    #                                     produced non-finite logits for this
    #                                     request's row (the ``bad`` tripwire)

    @property
    def wall_s(self) -> float:
        """End-to-end request latency: queueing + service."""
        return self.queue_s + self.service_s

    @property
    def new_tokens(self) -> int:
        return int(self.tokens.size)

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput while the request held a slot (0.0 when the
        recorded service time is zero — see :func:`safe_rate`)."""
        return safe_rate(self.new_tokens, self.service_s)

    @property
    def sequence(self) -> np.ndarray:
        """prompt + generated tokens."""
        return np.concatenate([self.request.prompt, self.tokens])


def pack_prompts(requests) -> tuple:
    """Right-pad request prompts to a fixed-shape batch.

    Returns ``(prompts (B, Pmax) int32, lengths (B,) int32)``.  Pad slots
    repeat the row's last real token; they sit beyond the row's committed
    length, so drafting masks them and the cache positions they prefill
    are overwritten/causally masked before ever being read.
    """
    if not requests:
        raise ValueError("pack_prompts needs at least one request")
    lengths = np.array([r.prompt.size for r in requests], np.int32)
    pmax = int(lengths.max())
    out = np.empty((len(requests), pmax), np.int32)
    for i, r in enumerate(requests):
        out[i, : r.prompt.size] = r.prompt
        out[i, r.prompt.size :] = r.prompt[-1]
    return out, lengths


def pad_prompt(prompt: np.ndarray, pmax: int) -> np.ndarray:
    """Right-pad one prompt to ``pmax`` with its last real token (the
    single-row analogue of :func:`pack_prompts`, used by slot admission)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    out = np.full((pmax,), prompt[-1], np.int32)
    out[: prompt.size] = prompt
    return out
