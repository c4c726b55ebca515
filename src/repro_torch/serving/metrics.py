"""Serving observability — port of ``repro/serving/metrics.py`` (host-only,
copied: importing the reference's module would load jax through
``repro/serving/__init__.py``).

:class:`ServerMetrics` is a sink of host-side hooks the serving
front-end (``repro_torch.serving.server``) calls as requests flow through:

    on_submit → on_admit → on_tokens* → on_finish      (served)
    on_submit → on_shed                                (deadline shed)
    on_submit → [on_admit → on_tokens*] → on_failed    (fault/cancel/timeout)

plus ``on_step`` (per scheduler tick: the occupancy gauge),
``on_slot_event`` (the drain target for ``Scheduler.on_event``),
``on_decode_step`` (per decode step: accepted-length and step wall-time
samples per drafter×verifier, :class:`AcceptanceStats`, which
``SpecEngine.telemetry`` also uses) and ``on_guardrail`` (the named
robustness counters: NaN trips, bf16 rescues, lane restarts, timeouts, …).
All timestamps come from the caller's clock (wall or virtual), so a
virtual-clock replay gives deterministic latency distributions; on the
card the serving loop stamps tokens after the tick's host read, which
waits for the device.  Latency and acceptance aggregates are bounded
log-bucketed :class:`~repro_torch.serving.histogram.Histogram`\\ s.

``completed + shed + failed == submitted`` is the conservation law
(:meth:`ServerMetrics.check_conservation`).  ``summary()`` returns the
reference's JSON schema, ``save()`` writes it, and
:meth:`ServerMetrics.expose_text` renders the Prometheus text exposition,
byte for byte as the reference's.  KV-cache gauges are pulled at summary
time from registered sources (each paged lane's ``PagedGroup.snapshot``).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.histogram import Histogram


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy: metrics
    must stay importable in the scheduler's framework-agnostic layer.

    Nearest-rank proper: the smallest value with at least ``⌈q/100·n⌉``
    samples at or below it (``q=0`` → min, ``q=100`` → max).  The
    previous implementation used Python ``round()``, whose banker's
    rounding made p50 of even-length lists inconsistent with the
    documented method (p50 of ``[1,2,3,4]`` returned 3, not 2).
    """
    if not values:
        return float("nan")
    v = sorted(values)
    k = max(1, min(len(v), math.ceil(q / 100.0 * len(v))))
    return float(v[k - 1])


def _dist(values) -> dict:
    """p50/p99/mean/max summary of a raw sample list."""
    if not values:
        return {"n": 0}
    return {
        "n": len(values),
        "mean": sum(values) / len(values),
        "p50": percentile(values, 50),
        "p99": percentile(values, 99),
        "max": max(values),
    }


@dataclass
class RequestTimeline:
    """Per-request latency timeline (all timestamps on the server clock).

    ``emits`` records every streaming delta as ``(t, n_tokens)``; TTFT
    and ITL derive from it.  A delta carries several tokens when a
    verify step accepts a multi-token draft — its gap is attributed
    evenly across the tokens it committed, so ITL reflects what a
    streaming client observes per token.
    """

    rid: int
    arrival_t: float
    deadline_t: Optional[float] = None     # absolute; None = no SLO
    admit_t: Optional[float] = None
    finish_t: Optional[float] = None
    status: str = "queued"                 # queued|running|done|shed|failed
    degraded: bool = False                 # served by the degraded lane
    emits: List[Tuple[float, int]] = field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        """Arrival → first streamed token."""
        return self.emits[0][0] - self.arrival_t if self.emits else None

    @property
    def itl(self) -> List[float]:
        """Per-token inter-token gaps after the first delta."""
        gaps: List[float] = []
        if len(self.emits) < 2:
            return gaps
        prev = self.emits[0][0]
        for t, n in self.emits[1:]:
            gaps.extend([(t - prev) / max(n, 1)] * n)
            prev = t
        return gaps

    @property
    def deadline_hit(self) -> Optional[bool]:
        """None when the request has no deadline; any terminal state
        other than ``done`` (shed, failed) counts as a miss."""
        if self.deadline_t is None:
            return None
        if self.status != "done" or self.finish_t is None:
            return False
        return self.finish_t <= self.deadline_t

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "status": self.status,
            "degraded": self.degraded,
            "arrival_t": self.arrival_t,
            "admit_t": self.admit_t,
            "finish_t": self.finish_t,
            "deadline_t": self.deadline_t,
            "deadline_hit": self.deadline_hit,
            "ttft": self.ttft,
            "n_tokens": sum(n for _, n in self.emits),
            "emits": [[t, n] for t, n in self.emits],
        }


class AcceptanceStats:
    """Per drafter×verifier decode-step telemetry: accepted-length and
    step wall-time histograms, bounded memory.

    One entry per ``"drafter:verifier"`` key.  ``accept_len`` samples
    are the per-row tokens committed by one verify step (the live L
    signal); ``step_s`` is host wall time of the whole fused step.
    Owned by both :class:`ServerMetrics` (server view) and
    ``SpecEngine.telemetry`` (engine view, batch/solo paths included).
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
        """One fused decode step: ``accepted`` is the per-active-row
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


# KV-cache snapshot keys summed across registered sources; everything a
# ``PagedGroup.snapshot()`` emits except the non-additive pool gauges.
_KV_SUMMED = (
    "prefix_hits", "prefix_misses", "shared_blocks", "shared_tokens",
    "cold_prefill_tokens", "cow_forks", "resurrections", "cached_evicted",
    "swap_out_blocks", "swap_in_blocks", "swap_out_bytes", "swap_in_bytes",
    "preemptions",
)


class ServerMetrics:
    """Aggregating sink for the serving front-end's lifecycle hooks."""

    def __init__(self, *, keep_timelines: bool = True):
        self.counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "completed": 0, "shed": 0,
            "failed": 0, "degraded": 0, "slot_events": 0,
            "stream_tokens": 0, "decode_steps": 0,
        }
        # robustness event counters (the reference's docs/robustness.md) —
        # pre-seeded so the zero baseline is visible in every summary/scrape
        self.robustness: Dict[str, int] = {
            "verify_nan_trips": 0,     # steps with non-finite verifier
            #                            logits on an active row
            "retry_rescued_rows": 0,   # rows saved by same-precision retry
            "bf16_rescued_rows": 0,    # rows saved by the bf16 fallback
            "unrescued_rows": 0,       # rows failed after the full ladder
            "collapse_trips": 0,       # acceptance-collapse detections
            "reprepares": 0,           # lane params re-quantized (repair)
            "lane_restarts": 0,        # serving-loop supervisor restarts
            "request_faults": 0,       # requests failed by step/admit fault
            "timeouts": 0,             # requests failed by request_timeout_s
            "cancelled": 0,            # requests failed by client cancel
            "rejected": 0,             # malformed/unservable at submit
        }
        self.keep_timelines = keep_timelines
        self.timelines: Dict[int, RequestTimeline] = {}
        # occupancy gauge: running aggregate, O(1) memory
        self._occ_samples = 0
        self._occ_sum = 0
        self._occ_max = 0
        self._slots_total = 0
        # latency aggregates: bounded log-bucketed histograms (memory is
        # O(buckets), independent of request count — the fix for the
        # unbounded raw lists keep_timelines=False used to accumulate)
        self._ttft = Histogram()
        self._itl = Histogram()
        self._queue = Histogram()
        self._service = Histogram()
        self._deadline_total = 0
        self._deadline_hits = 0
        self.acceptance = AcceptanceStats()
        # keyed by name: a lane rebuilt after a supervisor restart
        # re-registers under the same name and replaces its dead source
        self._kv_sources: Dict[str, Callable[[], dict]] = {}

    # -- lifecycle hooks ------------------------------------------------
    def on_submit(self, rid: int, t: float,
                  deadline_t: Optional[float] = None,
                  degraded: bool = False) -> None:
        self.counters["submitted"] += 1
        if degraded:
            self.counters["degraded"] += 1
        self.timelines[rid] = RequestTimeline(
            rid=rid, arrival_t=t, deadline_t=deadline_t, degraded=degraded)

    def on_admit(self, rid: int, t: float) -> None:
        self.counters["admitted"] += 1
        tl = self.timelines.get(rid)
        if tl is not None:
            tl.admit_t = t
            tl.status = "running"

    def on_tokens(self, rid: int, t: float, n: int) -> None:
        self.counters["stream_tokens"] += int(n)
        tl = self.timelines.get(rid)
        if tl is not None:
            tl.emits.append((t, int(n)))

    def on_finish(self, rid: int, t: float) -> None:
        self.counters["completed"] += 1
        tl = self.timelines.pop(rid) if not self.keep_timelines \
            else self.timelines.get(rid)
        if tl is None:
            return
        tl.finish_t = t
        tl.status = "done"
        self._fold(tl)

    def on_shed(self, rid: int, t: float) -> None:
        self.counters["shed"] += 1
        tl = self.timelines.pop(rid) if not self.keep_timelines \
            else self.timelines.get(rid)
        if tl is None:
            return
        tl.finish_t = t
        tl.status = "shed"
        self._fold(tl)

    def on_failed(self, rid: int, t: float) -> None:
        """Terminal ``failed`` state (fault, cancel, timeout, crash)."""
        self.counters["failed"] += 1
        tl = self.timelines.pop(rid) if not self.keep_timelines \
            else self.timelines.get(rid)
        if tl is None:
            return
        tl.finish_t = t
        tl.status = "failed"
        self._fold(tl)

    def on_guardrail(self, name: str, n: int = 1) -> None:
        """Bump a named robustness event counter (see ``self.robustness``
        for the pre-seeded vocabulary; unknown names are accepted so
        callers can add events without a schema change here)."""
        self.robustness[name] = self.robustness.get(name, 0) + int(n)

    def on_step(self, t: float, busy_slots: int, total_slots: int) -> None:
        """Occupancy gauge sample: one scheduler tick."""
        self._occ_samples += 1
        self._occ_sum += int(busy_slots)
        self._occ_max = max(self._occ_max, int(busy_slots))
        self._slots_total = max(self._slots_total, int(total_slots))

    def on_slot_event(self, ev) -> None:
        """Drain target for ``Scheduler.on_event``: counts completed slot
        occupancies so the audit trail survives in aggregate even when
        the scheduler's retained ``events`` list is capped."""
        self.counters["slot_events"] += 1

    def on_decode_step(self, key: str, accepted, step_s: float) -> None:
        """Per decode step acceptance telemetry (``Scheduler.
        on_step_stats`` target): ``key`` is ``"drafter:verifier"``."""
        self.counters["decode_steps"] += 1
        self.acceptance.on_decode_step(key, accepted, step_s)

    def add_kv_source(self, name: str, snapshot: Callable[[], dict]) -> None:
        """Register a KV-cache gauge source (e.g. one paged lane's
        ``PagedGroup.snapshot``); polled lazily at summary time.
        Re-registering a name replaces the previous source (lane
        restart), so monotone counters restart from the new pool."""
        self._kv_sources[name] = snapshot

    # -- aggregation ----------------------------------------------------
    def _fold(self, tl: RequestTimeline) -> None:
        if tl.deadline_t is not None:
            self._deadline_total += 1
            if tl.deadline_hit:
                self._deadline_hits += 1
        if tl.status != "done":
            return
        if tl.ttft is not None:
            self._ttft.add(tl.ttft)
        for gap in tl.itl:
            self._itl.add(gap)
        if tl.admit_t is not None:
            self._queue.add(tl.admit_t - tl.arrival_t)
            if tl.finish_t is not None:
                self._service.add(tl.finish_t - tl.admit_t)

    @property
    def deadline_hit_rate(self) -> Optional[float]:
        if self._deadline_total == 0:
            return None
        return self._deadline_hits / self._deadline_total

    def check_conservation(self) -> None:
        """No request silently lost: every submitted request reached
        exactly one terminal state — completed + shed + failed."""
        c = self.counters
        if c["completed"] + c["shed"] + c["failed"] != c["submitted"]:
            raise AssertionError(
                f"conservation violated: completed={c['completed']} + "
                f"shed={c['shed']} + failed={c['failed']} "
                f"!= submitted={c['submitted']}")

    def kv_cache_summary(self) -> dict:
        """Aggregate of all registered KV sources (counters summed,
        pool gauges listed per source) + the derived prefix hit rate."""
        out = {k: 0 for k in _KV_SUMMED}
        pools = {}
        for name, snap in self._kv_sources.items():
            s = snap()
            for k in _KV_SUMMED:
                out[k] += int(s.get(k, 0))
            if "pool" in s:
                pools[name] = s["pool"]
        probes = out["prefix_hits"] + out["prefix_misses"]
        out["prefix_hit_rate"] = (out["prefix_hits"] / probes
                                  if probes else None)
        out["sources"] = len(self._kv_sources)
        if pools:
            out["pools"] = pools
        return out

    def summary(self, *, include_requests: bool = False) -> dict:
        """JSON-ready metrics snapshot (the reference's schema,
        ``docs/observability.md``)."""
        out = {
            "counters": dict(self.counters),
            "occupancy": {
                "samples": self._occ_samples,
                "mean": (self._occ_sum / self._occ_samples
                         if self._occ_samples else 0.0),
                "max": self._occ_max,
                "slots": self._slots_total,
            },
            "latency": {
                "ttft_s": self._ttft.summary(),
                "itl_s": self._itl.summary(),
                "queue_s": self._queue.summary(),
                "service_s": self._service.summary(),
            },
            "deadlines": {
                "with_deadline": self._deadline_total,
                "hits": self._deadline_hits,
                "hit_rate": self.deadline_hit_rate,
            },
            "acceptance": self.acceptance.summary(),
            "robustness": dict(self.robustness),
            "kv_cache": self.kv_cache_summary(),
        }
        if include_requests and self.keep_timelines:
            out["requests"] = [self.timelines[r].to_dict()
                               for r in sorted(self.timelines)]
        return out

    def save(self, path: str, *, include_requests: bool = False) -> str:
        with open(path, "w") as f:
            json.dump(self.summary(include_requests=include_requests), f,
                      indent=1)
        return path

    # -- Prometheus-style exposition ------------------------------------
    def expose_text(self) -> str:
        """Prometheus text-format exposition of the summary (counters,
        gauges, latency/acceptance summaries with stat labels, KV-cache
        counters).  Deterministic ordering: scrape diffs are meaningful.
        """
        s = self.summary()
        lines: List[str] = []

        def emit(name, mtype, help_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, v in samples:
                if v is None or (isinstance(v, float) and math.isnan(v)):
                    continue
                lab = ("{" + ",".join(f'{k}="{val}"'
                                      for k, val in labels) + "}"
                       if labels else "")
                lines.append(f"{name}{lab} {v}")

        emit("serve_requests_total", "counter",
             "Requests by lifecycle outcome.",
             [([("event", k)], v) for k, v in sorted(s["counters"].items())])
        occ = s["occupancy"]
        emit("serve_slot_occupancy", "gauge", "Busy decode slots.",
             [([("stat", k)], occ[k]) for k in ("mean", "max", "slots")])
        for kind, d in sorted(s["latency"].items()):
            name = f"serve_latency_{kind}"
            emit(name, "gauge", f"Latency summary ({kind}).",
                 [([("stat", st)], d.get(st))
                  for st in ("n", "mean", "p50", "p99", "max")])
        emit("serve_robustness_total", "counter",
             "Fault-containment and guardrail event counters.",
             [([("event", k)], v)
              for k, v in sorted(s["robustness"].items())])
        dl = s["deadlines"]
        emit("serve_deadline_hit_rate", "gauge",
             "Deadline hit rate over requests with an SLO.",
             [([], dl["hit_rate"])])
        acc_samples, step_samples = [], []
        for key, e in s["acceptance"].items():
            drafter, _, verifier = key.partition(":")
            base = [("drafter", drafter), ("verifier", verifier)]
            acc_samples.append((base + [("stat", "mean")],
                                e["accept_len"].get("mean")))
            acc_samples.append((base + [("stat", "p50")],
                                e["accept_len"].get("p50")))
            acc_samples.append((base + [("stat", "steps")], e["steps"]))
            acc_samples.append((base + [("stat", "tokens")],
                                e["committed_tokens"]))
            step_samples.append((base + [("stat", "mean")],
                                 e["step_s"].get("mean")))
            step_samples.append((base + [("stat", "p99")],
                                 e["step_s"].get("p99")))
        emit("serve_accept_len", "gauge",
             "Accepted tokens per row-step (live L) by drafter/verifier.",
             acc_samples)
        emit("serve_decode_step_seconds", "gauge",
             "Decode step wall time by drafter/verifier.", step_samples)
        kv = s["kv_cache"]
        emit("serve_kv_cache_total", "counter",
             "Paged KV-cache event counters (summed over lanes).",
             [([("event", k)], kv[k]) for k in _KV_SUMMED])
        emit("serve_kv_prefix_hit_rate", "gauge",
             "Prefix-cache admission hit rate.",
             [([], kv["prefix_hit_rate"])])
        return "\n".join(lines) + "\n"
