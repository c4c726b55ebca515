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

Device times (``annotate_device=True`` on a machine with CUDA): a span
opened with ``device=True`` also records a CUDA timing event on the current
stream at its begin and at its end (none while the stream is capturing a
graph).  The events are read without a synchronise: :meth:`Tracer.anchor`,
called where the program already waits for the card (the tick's host read),
pairs a fresh event with the tracer's clock, and :meth:`Tracer.tick_end`
(and :meth:`export`) resolve the events that have completed against the
nearest anchor, so each device span's ``E`` event gets ``dev_t0``/``dev_t1``
args in µs on the tracer's own clock, and :meth:`export` adds one
``device`` track per lane (``tid + DEVICE_TRACK``) of complete (``ph: X``)
events.  The same mode turns ``torch.cuda``'s sync debug mode to "warn" while
any such tracer lives and counts each synchronising CUDA call made on the
tracer's own thread (the one that opens its first span) by the innermost
span open there: :meth:`Tracer.tick_end` emits them as one ``host_syncs``
counter per tick (``{span name: calls}``; ``outside`` for calls under no
span).

The reference's ``tools/check_trace.py`` validates the structural
invariants (matched B/E nesting per track, non-decreasing timestamps,
balanced async begin/end per id, required attrs).
"""
from __future__ import annotations

import json
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional

DEVICE_TRACK = 1000      # a lane's device track is tid + DEVICE_TRACK
SYNC_WARNING = "called a synchronizing CUDA operation"   # torch's sync debug mode


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

    def span(self, name: str, *, tid: int = 0, device: bool = False, **args):
        return _NULL_SPAN

    def anchor(self) -> None:
        pass

    def tick_end(self, tid: int = 0) -> None:
        pass

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
    ``torch.profiler.record_function`` range and device events)."""

    __slots__ = ("_tr", "_name", "_tid", "_args", "_recorded", "_ann", "_timed", "_mark")

    def __init__(self, tracer: "Tracer", name: str, tid: int,
                 args: Optional[dict], timed: bool):
        self._tr = tracer
        self._name = name
        self._tid = tid
        self._args = args
        self._recorded = False
        self._ann = None
        self._timed = timed
        self._mark = None

    def __enter__(self):
        tr = self._tr
        if tr._syncs is not None:
            tr._syncs.enter(self._name)
        self._recorded = tr._emit(
            {"ph": "B", "name": self._name, "tid": self._tid,
             **({"args": self._args} if self._args else {})})
        if tr._annotation is not None:
            self._ann = tr._annotation(self._name)
            self._ann.__enter__()
        if self._timed and self._recorded and tr._device is not None:
            self._mark = tr._device.record()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        if self._ann is not None:
            self._ann.__exit__(*exc)
        if tr._syncs is not None:
            tr._syncs.exit()
        if self._recorded:
            # E must pair with its B: only emit if the B made it in
            # (the max_events cap can drop the B but never orphan an E)
            ev = {"ph": "E", "name": self._name, "tid": self._tid}
            if exc and exc[0] is not None:
                # span ended by an exception — tag the closing event so
                # fault-containment paths are visible in the trace
                ev["args"] = {"error": exc[0].__name__}
            if self._mark is not None:
                tr._device.end(self._mark, ev)
            tr._emit(ev, force=True)
        return False


def _cuda_timing():
    """(a new timing event, "is the current stream capturing?") where
    CUDA is available, else None."""
    import torch

    if not torch.cuda.is_available():
        return None
    return (lambda: torch.cuda.Event(enable_timing=True),
            torch.cuda.is_current_stream_capturing)


class _DeviceTimes:
    """CUDA events at the begin and end of device spans, put on the
    tracer's clock through anchors: an event recorded where the host has
    just waited for the card completes at once, so its device time is the
    host time taken with it.  An event resolves against the last anchor
    before it (the first one after it, for events older than any anchor),
    so the two clocks never drift apart by more than a tick."""

    def __init__(self, new_event: Callable[[], Any], capturing: Callable[[], bool]):
        self._new = new_event
        self._capturing = capturing
        self._anchor = None      # (event, host µs) of the last wait
        self._pending: List[list] = []   # [E event, begin, end, anchor before, after]

    def record(self):
        """A timing event recorded on the current stream (None while it
        captures a graph)."""
        if self._capturing():
            return None
        ev = self._new()
        ev.record()
        return ev

    def end(self, begin, e_event: dict) -> None:
        end = self.record()
        if end is not None:
            self._pending.append([e_event, begin, end, self._anchor, None])

    def anchor(self, now_us: float) -> None:
        ev = self.record()
        if ev is None:
            return
        a = (ev, now_us)
        for p in self._pending:
            if p[3] is None and p[4] is None:
                p[4] = a
        self._anchor = a

    def resolve(self) -> None:
        """Stamp ``dev_t0``/``dev_t1`` on the spans whose events have
        completed (``Event.query``: no synchronise)."""
        keep = []
        for p in self._pending:
            ev, begin, end, before, after = p
            if not end.query():
                keep.append(p)
            elif before is not None:
                a, t = before
                ev.setdefault("args", {}).update(dev_t0=t + 1e3 * a.elapsed_time(begin),
                                                 dev_t1=t + 1e3 * a.elapsed_time(end))
            elif after is not None and after[0].query():
                a, t = after
                ev.setdefault("args", {}).update(dev_t0=t - 1e3 * begin.elapsed_time(a),
                                                 dev_t1=t - 1e3 * end.elapsed_time(a))
            else:
                keep.append(p)
        self._pending = keep


class _SyncCount:
    """One tracer's synchronising CUDA calls by the innermost span open on
    its own thread: the thread that opens its first span (the loop's
    driving thread).  Spans opened on any other thread are not tracked, and
    calls made there are not counted."""

    def __init__(self):
        self.owner: Optional[int] = None
        self.open: List[str] = []
        self.counts: Dict[str, int] = {}

    def enter(self, name: str) -> None:
        me = threading.get_ident()
        if self.owner is None:
            self.owner = me
        if me == self.owner:
            self.open.append(name)

    def exit(self) -> None:
        if threading.get_ident() == self.owner:
            self.open.pop()

    def count(self) -> None:
        name = self.open[-1] if self.open else "outside"
        self.counts[name] = self.counts.get(name, 0) + 1


class _SyncHook:
    """The process-wide half of the count, installed while at least one
    counting tracer lives: ``torch.cuda``'s sync debug mode at "warn" (a mode
    set before is kept), an "always" filter for its warning (not once per
    location) and ``warnings.showwarning``.  A sync warning goes to every
    live counter whose thread raised it, and on to the ``showwarning`` it
    replaced only where the sync debug mode was on before; other warnings
    pass on."""

    def __init__(self):
        self.counters: List[_SyncCount] = []
        self._show = None        # the showwarning it replaced
        self._saved = None       # (its filter, the sync debug mode before)

    def add(self, counter: _SyncCount) -> None:
        if not self.counters:
            self._install()
        self.counters.append(counter)

    def remove(self, counter: _SyncCount) -> None:
        self.counters.remove(counter)
        if not self.counters:
            self._uninstall()

    def showwarning(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            me = threading.get_ident()
            for c in self.counters:
                if c.owner == me:
                    c.count()
            if not self._saved[1]:
                return
        self._show(message, category, filename, lineno, file, line)

    def _install(self) -> None:
        import torch

        warnings.filterwarnings("always", message=SYNC_WARNING)
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            if not mode:
                torch.cuda.set_sync_debug_mode("warn")
        self._saved = (warnings.filters[0], mode)
        self._show = warnings.showwarning
        warnings.showwarning = self.showwarning

    def _uninstall(self) -> None:
        import torch

        flt, mode = self._saved
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        if flt in warnings.filters:
            warnings.filters.remove(flt)
            warnings._filters_mutated()
        if warnings.showwarning == self.showwarning:
            warnings.showwarning = self._show


_SYNC_HOOK = _SyncHook()


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
        span shows up in ``torch.profiler`` traces; where CUDA is
        available, ``device=True`` spans also get device times and
        synchronising CUDA calls are counted (module docstring).
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
        self._names: Dict[int, str] = {}          # tid -> track label
        self._annotation = None
        self._device: Optional[_DeviceTimes] = None
        self._syncs: Optional[_SyncCount] = None
        if annotate_device:
            from torch.profiler import record_function
            self._annotation = record_function
            self._syncs = _SyncCount()
            timing = _cuda_timing()
            if timing is not None:
                self._device = _DeviceTimes(*timing)
                _SYNC_HOOK.add(self._syncs)
                weakref.finalize(self, _SYNC_HOOK.remove, self._syncs).atexit = False

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
    def span(self, name: str, *, tid: int = 0, device: bool = False, **args):
        """Synchronous duration span (``with tracer.span("decode", ...):``).

        Spans on one ``tid`` must nest (LIFO) — the Chrome duration-event
        contract).  ``device=True`` marks a span of work on the card, which
        gets device times when they are on.
        """
        return _Span(self, name, tid, args or None, device)

    def anchor(self) -> None:
        """The host has just waited for the card: pair the tracer's clock
        with a device event here (see :class:`_DeviceTimes`)."""
        if self._device is not None:
            self._device.anchor(self._now_us())

    def tick_end(self, tid: int = 0) -> None:
        """End of a scheduler tick on track ``tid``: resolve the device
        events that have completed and emit the tick's ``host_syncs``."""
        if self._device is not None:
            self._device.resolve()
        if self._syncs is not None and self._syncs.counts:
            self.counter("host_syncs", self._syncs.counts, tid=tid)
            self._syncs.counts = {}

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
        self._names[tid] = name
        self._emit({"ph": "M", "name": "thread_name", "tid": tid,
                    "args": {"name": name}}, force=True)

    # ------------------------------------------------------------------
    def export(self) -> dict:
        """Trace-event JSON object (``{"traceEvents": [...], ...}``), with
        a ``device`` track per lane when device times are on."""
        events = list(self.events)
        if self._device is not None:
            self._device.resolve()
            events += self._device_tracks()
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def _device_tracks(self) -> List[Dict[str, Any]]:
        """A complete event per device span with its times, by start, on
        its lane's device track."""
        timed = sorted(((ev["tid"], ev["args"]["dev_t0"], -ev["args"]["dev_t1"], ev["name"])
                        for ev in self.events
                        if ev["ph"] == "E" and "dev_t0" in ev.get("args", ())))
        out, named = [], set()
        for tid, t0, neg_t1, name in timed:
            if tid not in named:
                named.add(tid)
                label = self._names.get(tid, f"lane {tid}")
                out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                            "tid": tid + DEVICE_TRACK, "args": {"name": f"{label} device"}})
            out.append({"ph": "X", "name": name, "pid": self.pid, "tid": tid + DEVICE_TRACK,
                        "ts": t0, "dur": -neg_t1 - t0})
        return out

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
