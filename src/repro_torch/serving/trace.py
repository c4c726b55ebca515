"""Zero-dependency span tracer with Chrome trace-event / Perfetto export —
port of ``repro/serving/trace.py``.

The serving stack (``serving/scheduler.py`` ticks, ``serving/engine.py``
paged admission/swap) emits structured
spans through one :class:`Tracer` so a whole request's life — queued →
admitted → running → finish/shed, with preempt/resume and swap-out/in
sub-spans — renders on one timeline in Perfetto / ``chrome://tracing``.

Design constraints, in priority order:

1. **Determinism.**  The clock is *injected* (``Tracer(clock=...)``), so
   a virtual-clock replay produces byte-identical trace JSON across runs:
   same workload + same seed ⇒ same bytes.  ``export()``
   serialises with sorted keys and fixed separators, and nothing
   non-deterministic (wall time, object ids, dict order) ever reaches an
   event.
2. **Zero dependencies.**  Pure stdlib at import.  The optional
   ``annotate_device=True`` mode wraps each span in
   ``torch.profiler.record_function`` (imported lazily) so host spans also
   appear on a ``torch.profiler`` timeline beside the card's kernels.
3. **Zero cost when off.**  ``NULL_TRACER`` is a shared no-op whose
   ``span()`` returns a reusable null context; every call site does
   ``tracer or NULL_TRACER`` once and never branches again.  Generated
   tokens are bit-identical with tracing enabled vs disabled because the
   tracer only *observes* host control flow (asserted end-to-end).

Event model (Chrome trace-event JSON, ``ts`` in microseconds):

* :meth:`Tracer.span` — synchronous duration events (``ph: B/E``) on a
  per-lane track (``tid``); they must nest, which the serving loop's
  tick → admit/decode/harvest structure guarantees.
* :meth:`Tracer.begin_async` / :meth:`Tracer.end_async` — async events
  (``ph: b/e``) keyed by ``(cat, id)`` for request lifecycle phases
  that overlap arbitrarily across requests.
* :meth:`Tracer.instant` (``ph: i``) for point events (shed),
  :meth:`Tracer.counter` (``ph: C``) for gauges (occupancy, free
  blocks), :meth:`Tracer.thread_name` (``ph: M``) to label tracks.

The reference's ``tools/check_trace.py`` validates the structural
invariants (matched B/E nesting per track, non-decreasing timestamps,
balanced async begin/end per id, required attrs).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional


class _NullSpan:
    """Reusable no-op context manager (shared instance, zero alloc)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: every ``Tracer`` method exists and does nothing.

    Call sites hold ``tracer or NULL_TRACER`` so the hot path never
    branches on "is tracing on?" — it just calls through.
    """

    __slots__ = ()

    def span(self, name: str, *, tid: int = 0, **args):
        return _NULL_SPAN

    def begin_async(self, name: str, aid: int, *, cat: str = "request",
                    **args) -> None:
        pass

    def end_async(self, name: str, aid: int, *, cat: str = "request",
                  **args) -> None:
        pass

    def instant(self, name: str, *, tid: int = 0, **args) -> None:
        pass

    def counter(self, name: str, values, *, tid: int = 0) -> None:
        pass

    def thread_name(self, tid: int, name: str) -> None:
        pass

    @property
    def enabled(self) -> bool:
        return False


NULL_TRACER = NullTracer()


class _Span:
    """Context manager emitting a ``B``/``E`` pair (plus an optional
    ``torch.profiler.record_function`` range)."""

    __slots__ = ("_tr", "_name", "_tid", "_args", "_recorded", "_device")

    def __init__(self, tracer: "Tracer", name: str, tid: int,
                 args: Optional[dict]):
        self._tr = tracer
        self._name = name
        self._tid = tid
        self._args = args
        self._recorded = False
        self._device = None

    def __enter__(self):
        self._recorded = self._tr._emit(
            {"ph": "B", "name": self._name, "tid": self._tid,
             **({"args": self._args} if self._args else {})})
        ann = self._tr._annotation
        if ann is not None:
            self._device = ann(self._name)
            self._device.__enter__()
        return self

    def __exit__(self, *exc):
        if self._device is not None:
            self._device.__exit__(*exc)
        if self._recorded:
            # E must pair with its B: only emit if the B made it in
            # (the max_events cap can drop the B but never orphan an E)
            ev = {"ph": "E", "name": self._name, "tid": self._tid}
            if exc and exc[0] is not None:
                # span ended by an exception — tag the closing event so
                # fault-containment paths are visible in the trace
                ev["args"] = {"error": exc[0].__name__}
            self._tr._emit(ev, force=True)
        return False


class Tracer:
    """Collects trace events against an injectable clock.

    Parameters
    ----------
    clock:
        Seconds-valued monotone callable.  Inject a virtual clock for
        deterministic traces; defaults to ``time.perf_counter``.
    pid:
        Process id stamped on every event (one serving process = one
        pid track group).
    max_events:
        Optional bound on retained events — a long-lived server caps
        memory.  New ``B``/async-begin/instant/counter events are
        *dropped* once full (counted in ``dropped``); ``E``/async-end
        events whose begin was recorded always land so the trace stays
        structurally valid.
    annotate_device:
        When True, each :meth:`span` additionally enters a
        ``torch.profiler.record_function`` range of the same name, so the
        span shows up in ``torch.profiler`` traces.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter, *,
                 pid: int = 1, max_events: Optional[int] = None,
                 annotate_device: bool = False):
        if max_events is not None and max_events < 0:
            raise ValueError("max_events must be >= 0 (or None)")
        self._clock = clock
        self.pid = int(pid)
        self.max_events = max_events
        self.dropped = 0
        self.events: List[Dict[str, Any]] = []
        self._open_async: Dict[tuple, int] = {}   # (cat, id, name) -> depth
        self._annotation = None
        if annotate_device:
            from torch.profiler import record_function
            self._annotation = record_function

    @property
    def enabled(self) -> bool:
        return True

    # ------------------------------------------------------------------
    def _now_us(self) -> float:
        return self._clock() * 1e6

    def _emit(self, ev: Dict[str, Any], *, force: bool = False) -> bool:
        """Stamp + append ``ev``; returns False when dropped by the cap."""
        if (not force and self.max_events is not None
                and len(self.events) >= self.max_events):
            self.dropped += 1
            return False
        ev.setdefault("tid", 0)
        ev["pid"] = self.pid
        if ev["ph"] != "M":
            ev["ts"] = self._now_us()
        self.events.append(ev)
        return True

    # ------------------------------------------------------------------
    def span(self, name: str, *, tid: int = 0, **args):
        """Synchronous duration span (``with tracer.span("decode", ...):``).

        Spans on one ``tid`` must nest (LIFO) — the Chrome duration-event
        contract).
        """
        return _Span(self, name, tid, args or None)

    def begin_async(self, name: str, aid: int, *, cat: str = "request",
                    **args) -> None:
        """Open an async phase ``name`` for id ``aid`` (e.g. one request's
        ``queued`` / ``running`` / ``preempted`` lifecycle phase)."""
        key = (cat, aid, name)
        ev = {"ph": "b", "cat": cat, "id": aid, "name": name,
              **({"args": args} if args else {})}
        if self._emit(ev):
            self._open_async[key] = self._open_async.get(key, 0) + 1

    def end_async(self, name: str, aid: int, *, cat: str = "request",
                  **args) -> None:
        """Close the async phase opened by :meth:`begin_async`.

        A close with no recorded open (possible only under the
        ``max_events`` cap) is skipped so begins/ends stay balanced.
        """
        key = (cat, aid, name)
        depth = self._open_async.get(key, 0)
        if depth <= 0:
            return
        self._open_async[key] = depth - 1
        self._emit({"ph": "e", "cat": cat, "id": aid, "name": name,
                    **({"args": args} if args else {})}, force=True)

    def instant(self, name: str, *, tid: int = 0, **args) -> None:
        """Point event (``ph: i``, thread-scoped)."""
        self._emit({"ph": "i", "s": "t", "name": name, "tid": tid,
                    **({"args": args} if args else {})})

    def counter(self, name: str, values, *, tid: int = 0) -> None:
        """Counter sample: ``values`` is a number or a {series: number}
        dict (Perfetto stacks multi-series counters)."""
        if not isinstance(values, dict):
            values = {name: values}
        self._emit({"ph": "C", "name": name, "tid": tid,
                    "args": {k: float(v) for k, v in values.items()}})

    def thread_name(self, tid: int, name: str) -> None:
        """Label track ``tid`` (metadata event, no timestamp)."""
        self._emit({"ph": "M", "name": "thread_name", "tid": tid,
                    "args": {"name": name}}, force=True)

    # ------------------------------------------------------------------
    def export(self) -> dict:
        """Trace-event JSON object (``{"traceEvents": [...], ...}``)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dumps(self) -> str:
        """Deterministic serialisation: sorted keys, fixed separators —
        identical inputs produce byte-identical output."""
        return json.dumps(self.export(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path: str) -> str:
        """Write the trace to ``path``; open the file in Perfetto
        (https://ui.perfetto.dev) or ``chrome://tracing``."""
        with open(path, "w") as f:
            f.write(self.dumps())
            f.write("\n")
        return path
