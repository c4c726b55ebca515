"""Deterministic fault injection for the serving stack — port of
``repro/serving/faults.py`` (host-only: the exception types, ``FaultPlan``
and ``NULL_FAULTS``; ``poison_params`` waits for the slice that ports the
serving front-end's NaN guardrail).

A seeded :class:`FaultPlan` decides, at named *seams*, whether an
injected failure fires.  The seams cover every class of runtime fault
the serving loop must contain (the reference's ``docs/robustness.md`` maps each
one to its containment and observable signal):

  ``submit``        malformed / corrupted request at ingestion
  ``admit``         exception inside the admission (prefill) hook
  ``step``          exception inside the lane's step function
  ``poll``          exception escaping the poll loop (worker crash —
                    exercises the lane supervisor's restart path)
  ``nan_verify``    transient NaN/Inf logits out of the verifier for
                    one step (device bitflip / numerics glitch)
  ``quant_corrupt`` sticky corruption of the lane's *prepared*
                    (quantized) params — every later step is poisoned
                    until the lane re-prepares them
  ``alloc``         ``BlockPool`` allocation failure (admission or
                    mid-``_append_paged_blocks``)
  ``swap_in``       corruption of a preemption snapshot on resume
  ``stall``         slow/hung tick (``delay`` returns a sleep length)

Determinism: each seam owns an independent ``numpy`` Generator seeded
from ``(seed, seam index)`` plus a per-seam call counter, so a plan
replayed against the same deterministic serving run (virtual clock,
single poller) fires at exactly the same points.

Zero overhead when no plan is installed: call sites hold the shared
:data:`NULL_FAULTS` singleton (mirroring ``trace.NULL_TRACER``) whose
``fire`` is a constant ``False`` — they never branch on "is a plan
installed".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Every seam a plan may target, in a fixed order (the order seeds the
#: per-seam RNG streams — do not reorder, append only).
SEAMS = ("submit", "admit", "step", "poll", "nan_verify", "quant_corrupt",
         "alloc", "swap_in", "stall")


# ---------------------------------------------------------------------------
# Exceptions
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """Raised by a firing fault hook — the thing containment contains."""


class RequestFault(RuntimeError):
    """A step-phase failure attributable to specific slots.

    Raised by the lane step function when it can pin a failure on
    particular rows (unrescuable NaN, per-slot block-append failure).
    ``Scheduler.tick`` catches it, adopts ``state`` (a coherent
    engine state to continue from, when the raiser has one), and fails
    only the ``slots`` listed — ``None`` means every occupied slot.
    """

    def __init__(self, msg: str, *, slots: Optional[List[int]] = None,
                 state: Optional[dict] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.slots = list(slots) if slots is not None else None
        self.state = state
        self.cause = cause


class VerifierNaNError(RuntimeError):
    """Non-finite verifier logits that survived every fallback stage."""


class RequestCancelled(RuntimeError):
    """Terminal error carried by a request the client cancelled."""


class RequestTimeout(RuntimeError):
    """Terminal error carried by a request that exceeded
    ``ServerConfig.request_timeout_s``."""


class LaneCrashed(RuntimeError):
    """Terminal error carried by in-flight requests when the serving
    loop's worker thread crashed (the supervisor records the original
    exception as ``__cause__``)."""


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultRule:
    """When one seam fires.

    * ``at`` — explicit per-seam call indices (0-based) that always
      fire; the precise scalpel the fault-matrix tests use.
    * ``p`` — independent per-call firing probability (seeded, so still
      deterministic); the chaos benchmark's shotgun.
    * ``count`` — cap on total firings (``None`` = unlimited).
    * ``delay_s`` — for the ``stall`` seam: how long a firing stalls.
    """

    p: float = 0.0
    at: Tuple[int, ...] = ()
    count: Optional[int] = None
    delay_s: float = 0.0


class NullFaultPlan:
    """No-op plan: never fires, never delays.

    Shared singleton (:data:`NULL_FAULTS`) installed by default so call
    sites pay one attribute load + a constant-returning call — the same
    zero-cost-off pattern as ``trace.NULL_TRACER``.
    """

    enabled = False

    def fire(self, seam: str, **ctx) -> bool:  # noqa: ARG002
        return False

    def delay(self, seam: str = "stall") -> float:  # noqa: ARG002
        return 0.0


NULL_FAULTS = NullFaultPlan()


class FaultPlan:
    """Seeded, seam-addressed fault schedule.

    ``rules`` maps seam name → :class:`FaultRule` (or a kwargs dict).
    ``fire(seam, **ctx)`` returns whether this call's fault fires and
    appends a record to ``log`` when it does — the chaos gate uses the
    log to know which requests a run *intended* to disturb.
    """

    enabled = True

    def __init__(self, rules: Dict[str, object], seed: int = 0):
        self.seed = int(seed)
        self.rules: Dict[str, FaultRule] = {}
        for seam, rule in dict(rules).items():
            if seam not in SEAMS:
                raise ValueError(f"unknown fault seam {seam!r}; "
                                 f"expected one of {SEAMS}")
            if isinstance(rule, dict):
                rule = FaultRule(**rule)
            self.rules[seam] = rule
        self.calls: Dict[str, int] = {s: 0 for s in SEAMS}
        self.fired: Dict[str, int] = {s: 0 for s in SEAMS}
        self.log: List[dict] = []
        self._rng = {s: np.random.default_rng([self.seed, k])
                     for k, s in enumerate(SEAMS)}

    def fire(self, seam: str, **ctx) -> bool:
        rule = self.rules.get(seam)
        n = self.calls[seam]
        self.calls[seam] = n + 1
        if rule is None:
            return False
        # the probability draw is unconditional per call (when p > 0) so
        # the stream stays aligned whatever `at` contains
        hit = rule.p > 0.0 and float(self._rng[seam].random()) < rule.p
        hit = hit or (n in rule.at)
        if hit and rule.count is not None and self.fired[seam] >= rule.count:
            hit = False
        if hit:
            self.fired[seam] += 1
            self.log.append({
                "seam": seam, "call": n,
                **{k: v for k, v in sorted(ctx.items())
                   if isinstance(v, (int, float, str, bool))}})
        return hit

    def delay(self, seam: str = "stall") -> float:
        rule = self.rules.get(seam)
        if rule is None:
            return 0.0
        return rule.delay_s if self.fire(seam) else 0.0

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {s: {"calls": self.calls[s], "fired": self.fired[s]}
                for s in SEAMS if self.calls[s] or self.fired[s]}

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0,
              stall_s: float = 1.0) -> "FaultPlan":
        """Build a plan from a compact CLI spec.

        Comma-separated terms: ``seam@i`` / ``seam@i+j+k`` fire at
        explicit call indices; ``seam~p`` fires with probability ``p``
        per call.  ``stall`` terms use ``stall_s`` as the delay.
        Example: ``"step@3,alloc~0.05,nan_verify@2,stall~0.02"``.
        """
        rules: Dict[str, FaultRule] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "@" in part:
                seam, _, idx = part.partition("@")
                at = tuple(int(x) for x in idx.split("+"))
                rules[seam] = FaultRule(
                    at=at, delay_s=stall_s if seam == "stall" else 0.0)
            elif "~" in part:
                seam, _, p = part.partition("~")
                rules[seam] = FaultRule(
                    p=float(p), delay_s=stall_s if seam == "stall" else 0.0)
            else:
                raise ValueError(
                    f"bad fault term {part!r}: expected seam@i[+j...] "
                    "or seam~p")
        return cls(rules, seed=seed)
