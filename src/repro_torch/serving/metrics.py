"""Decode-step telemetry — port of ``AcceptanceStats`` from
``repro/serving/metrics.py`` (host-only, copied).  The rest of the
reference module (``ServerMetrics``, the serving front-end's sink) waits
for the slice that ports the front-end.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serving.histogram import Histogram


class AcceptanceStats:
    """Per drafter×verifier decode-step telemetry: accepted-length and
    step wall-time histograms, bounded memory.

    One entry per ``"drafter:verifier"`` key.  ``accept_len`` samples
    are the per-row tokens committed by one verify step (the live L
    signal); ``step_s`` is host wall time of the whole step.  Owned by
    ``SpecEngine.telemetry`` (``generate`` and ``generate_requests`` both
    feed it).
    """

    def __init__(self):
        self._per_key: Dict[str, dict] = {}

    def _entry(self, key: str) -> dict:
        e = self._per_key.get(key)
        if e is None:
            e = self._per_key[key] = {
                "steps": 0,
                "tokens": 0,
                # accepted lengths are small ints >= 0: min_value .5
                # puts 0 in the underflow bucket and 1, 2, 3... in
                # distinct buckets up to max_value
                "accept_len": Histogram(min_value=0.5, max_value=4096,
                                        growth=1.15),
                "step_s": Histogram(),
            }
        return e

    def on_decode_step(self, key: str, accepted, step_s: float) -> None:
        """One decode step: ``accepted`` is the per-active-row
        committed-token count, ``step_s`` the step's wall time."""
        e = self._entry(key)
        e["steps"] += 1
        for a in accepted:
            e["accept_len"].add(float(a))
            e["tokens"] += int(a)
        if step_s >= 0:
            e["step_s"].add(float(step_s))

    def mean_accept(self, key: str) -> Optional[float]:
        """Mean accepted length per row-step (the measured L)."""
        e = self._per_key.get(key)
        if e is None or not e["accept_len"].count:
            return None
        return e["accept_len"].mean

    @property
    def keys(self) -> List[str]:
        return sorted(self._per_key)

    def summary(self) -> dict:
        return {
            key: {
                "steps": e["steps"],
                "committed_tokens": e["tokens"],
                "accept_len": e["accept_len"].summary(),
                "step_s": e["step_s"].summary(),
            }
            for key, e in sorted(self._per_key.items())
        }
