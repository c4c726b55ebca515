"""Slot-level continuous batching: admit → step → harvest — port of
``repro/serving/scheduler.py``.

The scheduler keeps the fixed-shape batched decode loop saturated.  A
serving *group* (requests sharing a temperature) gets ``batch_slots``
rows in the engine state; the scheduler

1. **admits** pending requests into free slots
   (``SpecEngine.prefill_into_slot`` resets the row's token buffer,
   KV cache slice (or block-table row), drafter-state row, per-row
   generator, ``length`` / ``target`` and per-row stats — in place, so
   the state keeps its tensors and shapes);
2. **steps** the whole batch through the decode step;
3. **harvests** rows whose per-row ``target`` fired (``length >=
   target``), records the request's tokens + queue/service timing, and
   frees the slot for the next admission;

until the pending queue drains and every slot is empty.  Because each
row's generator, cache slice and token buffer are functions of its own
request only, the harvested tokens equal serving the request solo —
scheduling is an invisible throughput optimisation, never a semantic one.

Two driving modes share the same machinery:

* **batch** — :meth:`Scheduler.run` drains a fixed request list and
  returns results in request order (``SpecEngine.generate_requests``);
* **open-loop** — a caller :meth:`submit`\\ s requests as they arrive
  and calls :meth:`tick` once per decode step, interleaving arrival
  ingestion, deadline shedding (:meth:`shed_pending`) and harvesting.

Admission order is a policy: ``"fifo"`` pops pending requests by
``(priority, arrival)``; ``"edf"`` pops by ``(priority, deadline,
arrival)`` — earliest-deadline-first within a priority class.  Both only
reorder *admission*: per-request generators keep the generated tokens
invariant to scheduling.

Per-request **streaming** rides the harvest machinery: pass
``on_tokens`` to :meth:`run`/:meth:`tick` and after every step each
occupied row's newly-committed tokens are forwarded as
``on_tokens(request_index, np.ndarray)``.  The concatenation of a
request's deltas equals its final ``RequestResult.tokens`` (committed
positions are never rewritten).

The scheduler orchestrates through callables (``admit``, ``step``, …)
and reads the engine state schema (``repro_torch.core.spec_engine.
init_state``) after each step with **one device-to-host transfer per
tick** (:func:`host_view`: lengths, targets, per-row stats and the token
buffer packed into one tensor), where the reference reads each with its
own ``np.asarray`` (which a CUDA tensor refuses).
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from repro_torch.serving.faults import RequestFault
from repro_torch.serving.request import GenerationRequest, RequestResult
from repro_torch.serving.trace import NULL_TRACER


def host_view(state: dict) -> dict:
    """The state the scheduler reads after a step, as numpy, from one
    device-to-host copy: ``length``, ``target``, ``commits``,
    ``row_steps`` and ``bad`` (B,) and ``tokens`` (B, S_buf)."""
    stats = state["stats"]
    names = ("length", "target", "commits", "row_steps", "bad")
    rows = [state["length"], state["target"], stats["commits"], stats["row_steps"],
            stats["bad"]]
    B = rows[0].shape[0]
    packed = torch.cat([r.to(torch.int32) for r in rows]
                       + [state["tokens"].reshape(-1)]).cpu().numpy()
    out = {name: packed[i * B:(i + 1) * B] for i, name in enumerate(names)}
    out["tokens"] = packed[len(names) * B:].reshape(B, -1)
    return out


@dataclass
class SlotEvent:
    """Audit-trail entry: one request's occupancy of one slot."""

    request_index: int
    slot: int
    admit_step: int            # scheduler step count at admission
    harvest_step: int = -1     # step count when the row was harvested
    streamed: int = 0          # new tokens already forwarded via on_tokens
    preempted: bool = False    # occupancy ended by eviction, not harvest
    failed: bool = False       # occupancy ended by a contained failure


@dataclass
class Scheduler:
    """Continuous-batching loop over a fixed number of decode slots.

    ``run`` returns per-request :class:`RequestResult` in request order.
    Admission is **priority-aware**: pending requests pop by
    ``(request.priority, arrival index)`` — lower priority value first,
    FIFO within a class — so an urgent late arrival jumps the queue the
    moment a slot frees, while the all-default case is plain FIFO.
    With ``policy="edf"`` the key becomes ``(priority, deadline,
    arrival)``: earliest absolute deadline first inside each priority
    class (requests without a deadline sort last).  Priority and policy
    only reorder *admission* (they shift ``queue_s``); per-row seed
    streams keep every request's tokens independent of when it was
    admitted.

    The ``events`` audit trail records every (request, slot) occupancy
    with admit/harvest step counts — the property tests assert the
    scheduler's conservation laws on it (every request served exactly
    once, no slot double-booked).  A long-lived server bounds its
    growth: ``max_events`` caps the retained list (oldest dropped
    first), and ``on_event`` streams each *completed* event (harvest
    time, so admit/harvest steps are both final) to an observability
    sink before any trimming — set both and the full trail survives in
    aggregate form while the in-memory list stays O(cap).  Both default
    off, keeping test-mode behaviour byte-identical.

    Conservation counters for the open-loop mode: ``submitted`` (all
    requests ever accepted), ``results`` (request index → result) and
    ``shed_indices`` (requests dropped by :meth:`shed_pending` before
    ever holding a slot) and ``failed`` (request index → exception: the
    terminal state of requests killed by a contained failure).
    ``completed + shed + failed == submitted`` once idle — no request
    is silently lost (property-tested; :meth:`check_conservation`).

    **Observability** (all optional, zero-cost when unset):

    * ``tracer`` — a :class:`repro_torch.serving.trace.Tracer`.  The scheduler
      emits per-tick duration spans (``tick`` → ``admit`` / ``decode`` /
      ``harvest`` / ``preempt`` on track ``trace_tid``) and per-request
      async lifecycle phases (``queued`` → ``running`` → finish, with
      ``preempted`` interludes and ``shed`` instants) keyed by the
      request's trace id.
    * ``trace_ids`` — external ids for the batch path's initial
      requests (``generate_requests`` passes the caller's request
      indices); open-loop callers pass ``trace_id=`` per
      :meth:`submit`.  Defaults to the scheduler-local index.
    * ``on_step_stats(accepted, step_s, n_tokens)`` — called after
      every decode step with the per-active-row committed-token counts
      (derived host-side from the length deltas the harvest already
      reads — no extra device sync), the step wall time (up to the
      tick's one host read, so the card's work is in it), and their sum.
      The serving loop folds this into acceptance histograms per
      drafter×verifier.
    """

    requests: Sequence[GenerationRequest]
    batch_slots: int
    policy: str = "fifo"                       # "fifo" | "edf"
    max_events: Optional[int] = None           # retained-events cap
    on_event: Optional[Callable[[SlotEvent], None]] = None
    events: List[SlotEvent] = field(default_factory=list)
    steps: int = 0             # decode steps taken by the loop
    preemptions: int = 0       # running slots evicted for a better head
    tracer: Optional[object] = None            # trace.Tracer (or None)
    trace_tid: int = 0                         # tracer track for spans
    trace_ids: Optional[Sequence[int]] = None  # ids for initial requests
    on_step_stats: Optional[Callable[[List[int], float, int], None]] = None

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if self.policy not in ("fifo", "edf"):
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             "expected 'fifo' or 'edf'")
        if self.max_events is not None and self.max_events < 0:
            raise ValueError("max_events must be >= 0 (or None)")
        initial = list(self.requests)
        self.requests = []
        self.results: Dict[int, RequestResult] = {}
        self.shed_indices: List[int] = []
        # terminal `failed` state: request index -> the exception that
        # killed it.  Conservation becomes
        # completed + shed + failed == submitted (check_conservation)
        self.failed: Dict[int, BaseException] = {}
        self._deadlines: List[float] = []      # absolute, math.inf = none
        self._arrival_t: List[float] = []
        self._pending: List[tuple] = []
        self._slots: List[Optional[SlotEvent]] = [None] * self.batch_slots
        self._admit_t = [0.0] * self.batch_slots
        # preemption accounting: queue_s is measured to the FIRST
        # admission (being evicted and resumed is service disruption,
        # not queueing) and streaming resumes where it left off
        self._first_admit_t: Dict[int, float] = {}
        self._resume_streamed: Dict[int, int] = {}
        self._tr = self.tracer if self.tracer is not None else NULL_TRACER
        self._trace_ids_list: List[int] = []
        # host-side committed length per slot: admission knows the
        # prompt length (fresh) or the preemption snapshot (resume), and
        # the harvest already reads post-step lengths — so per-step
        # accepted-token counts cost zero extra device syncs
        self._row_len = [0] * self.batch_slots
        self._preempted_len: Dict[int, int] = {}
        self._preempted: set = set()
        ids = list(self.trace_ids) if self.trace_ids is not None else None
        if ids is not None and len(ids) != len(initial):
            raise ValueError("trace_ids must match the initial requests")
        now = time.perf_counter()
        for j, r in enumerate(initial):
            self.submit(r, arrival_t=now,
                        trace_id=ids[j] if ids is not None else None)

    # ------------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return bool(self._pending) or any(
            ev is not None for ev in self._slots)

    @property
    def submitted(self) -> int:
        return len(self.requests)

    @property
    def completed(self) -> int:
        return len(self.results)

    @property
    def shed(self) -> int:
        return len(self.shed_indices)

    @property
    def failed_count(self) -> int:
        return len(self.failed)

    def check_conservation(self) -> None:
        """Assert the terminal-state conservation law: every submitted
        request is exactly one of completed / shed / failed (meaningful
        once ``busy`` is False)."""
        got = self.completed + self.shed + self.failed_count
        assert got == self.submitted, (
            f"conservation broken: completed {self.completed} + shed "
            f"{self.shed} + failed {self.failed_count} = {got} "
            f"!= submitted {self.submitted}")

    def _key(self, i: int) -> tuple:
        pr = int(getattr(self.requests[i], "priority", 0))
        if self.policy == "edf":
            return (pr, self._deadlines[i], i)
        return (pr, i)

    # ------------------------------------------------------------------
    def submit(self, request: GenerationRequest, *,
               arrival_t: Optional[float] = None,
               deadline: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        """Enqueue ``request``; returns its request index.

        ``arrival_t`` stamps when the request arrived (``perf_counter``
        clock, or the caller's injected clock) — ``queue_s`` is measured
        from it.  ``deadline`` is the *absolute* deadline on the same
        clock; when omitted it is derived as ``arrival_t +
        request.deadline_s`` (``inf`` if the request has no deadline).
        ``trace_id`` names the request in trace lifecycle spans (the
        serving front-end passes its global request id); defaults to the
        scheduler-local index.  Safe to call mid-loop between
        :meth:`tick`\\ s — this is the open-loop ingestion path.
        """
        i = len(self.requests)
        self.requests.append(request)
        arrival = time.perf_counter() if arrival_t is None else arrival_t
        if deadline is None:
            dl = getattr(request, "deadline_s", None)
            deadline = math.inf if dl is None else arrival + float(dl)
        self._arrival_t.append(arrival)
        self._deadlines.append(float(deadline))
        self._trace_ids_list.append(i if trace_id is None else int(trace_id))
        rid = self._trace_ids_list[i]
        targs = {"rid": rid,
                 "priority": int(getattr(request, "priority", 0))}
        if math.isfinite(deadline):
            targs["deadline_s"] = float(deadline)
        self._tr.begin_async("queued", rid, **targs)
        heapq.heappush(self._pending, self._key(i))
        return i

    def _rid(self, i: int) -> int:
        return self._trace_ids_list[i]

    def deadline(self, i: int) -> float:
        """Absolute deadline of request ``i`` (``inf`` if none)."""
        return self._deadlines[i]

    def shed_pending(self, now: float, *, slack: float = 0.0) -> List[int]:
        """Drop still-queued requests whose deadline has (effectively)
        passed: ``deadline <= now + slack``.

        ``slack`` pre-sheds requests that would miss even if admitted
        right now (e.g. an estimated minimum service time).  Only
        *pending* requests are shed — a request already holding a slot
        runs to completion (its tokens are already partially committed).
        Returns the shed request indices; they are recorded in
        ``shed_indices`` so ``completed + shed + failed == submitted``
        stays an invariant.  Never called by the batch :meth:`run` path —
        ``generate_requests`` serves every request.
        """
        cut = now + slack
        keep, out = [], []
        for key in self._pending:
            i = key[-1]
            (out if self._deadlines[i] <= cut else keep).append(key)
        if out:
            heapq.heapify(keep)
            self._pending = keep
            self.shed_indices.extend(key[-1] for key in out)
            for key in out:
                i = key[-1]
                rid = self._rid(i)
                phase = "preempted" if i in self._preempted else "queued"
                self._preempted.discard(i)
                self._preempted_len.pop(i, None)
                self._tr.end_async(phase, rid)
                self._tr.instant("shed", tid=self.trace_tid, rid=rid)
        return [key[-1] for key in out]

    # ------------------------------------------------------------------
    def _record_admit(self, ev: SlotEvent) -> None:
        self.events.append(ev)
        if self.max_events is not None and len(self.events) > self.max_events:
            del self.events[: len(self.events) - self.max_events]

    def tick(
        self,
        state: dict,
        *,
        admit: Callable[[dict, int, int], dict],
        step: Callable[[dict], dict],
        can_admit: Optional[Callable[[int], bool]] = None,
        release: Optional[Callable[[dict, int, int], dict]] = None,
        preempt: Optional[Callable[[dict, int, int], dict]] = None,
        on_tokens: Optional[Callable[[int, np.ndarray], None]] = None,
        on_fail: Optional[
            Callable[[dict, Optional[int], int, BaseException], dict]] = None,
        clock: Callable[[], float] = time.perf_counter,
        guard: Optional[Callable[[dict, dict], tuple]] = None,
    ) -> tuple:
        """One admission wave + one batch step + harvest.

        The open-loop building block :meth:`run` iterates (hook
        contracts are documented there).  Additionally:

        * ``on_tokens(request_index, tokens)`` — per-request streaming:
          called after the step for every occupied row that committed
          new tokens, with the newly-committed ``np.int32`` slice
          (clipped to the request's budget).  Deltas concatenate
          bit-identically to the final ``RequestResult.tokens``.
        * ``on_fail(state, slot, request_index, exc) -> state`` —
          failure-containment hook, called after a request transitions
          to the terminal ``failed`` state (``slot`` is None when it
          never held one this occupancy).  The serving front-end idles
          the engine row and finishes the stream handle here; ``release``
          has already returned the request's blocks.
        * ``clock`` — timestamp source for queue/service accounting
          (injectable so load-replay benchmarks can run on a virtual
          clock).
        * ``guard(state, host) -> (state, host)`` — runs after the step
          on the tick's one host read (:func:`host_view`), inside the
          step's containment: the serving lane's NaN guardrail reads
          ``host["bad"]`` there instead of syncing again, and may rerun
          the step (returning a fresh host view) or raise
          :class:`~repro_torch.serving.faults.RequestFault`.

        **Failure containment**: an exception escaping the ``admit``
        hook fails only the request being admitted; an exception
        escaping ``step`` fails the occupied slots it is attributable to
        (a :class:`~repro_torch.serving.faults.RequestFault` names them and
        may carry a coherent post-fault state to adopt — any other
        exception conservatively fails every occupied slot, since the
        batch step is all-or-nothing) and the tick returns with no
        harvest.  Queued work and the scheduler itself survive either
        way.

        Returns ``(state, harvested request indices)``; results land in
        ``self.results``.
        """
        with self._tr.span("tick", tid=self.trace_tid, step=self.steps):
            out = self._tick_inner(
                state, admit=admit, step=step, can_admit=can_admit,
                release=release, preempt=preempt, on_tokens=on_tokens,
                on_fail=on_fail, clock=clock, guard=guard)
        self._tr.tick_end(self.trace_tid)
        return out

    def _tick_inner(
        self,
        state: dict,
        *,
        admit: Callable[[dict, int, int], dict],
        step: Callable[[dict], dict],
        can_admit: Optional[Callable[[int], bool]] = None,
        release: Optional[Callable[[dict, int, int], dict]] = None,
        preempt: Optional[Callable[[dict, int, int], dict]] = None,
        on_tokens: Optional[Callable[[int, np.ndarray], None]] = None,
        on_fail: Optional[
            Callable[[dict, Optional[int], int, BaseException], dict]] = None,
        clock: Callable[[], float] = time.perf_counter,
        guard: Optional[Callable[[dict, dict], tuple]] = None,
    ) -> tuple:
        while self._pending:
            free_slot = next((s for s in range(self.batch_slots)
                              if self._slots[s] is None), None)
            if free_slot is None:
                break
            head_key = self._pending[0]
            i = head_key[-1]
            if can_admit is not None and not can_admit(i):
                # head-of-line gate: a denied head blocks the wave so
                # admission order (and queue_s) stays priority-exact.
                # With a preempt hook, evict strictly-worse-key running
                # occupants (lowest priority first) until the head fits
                # — their blocks move to the host swap pool and they
                # re-enter the queue with their original keys.
                while preempt is not None and not can_admit(i):
                    victim = None
                    for s in range(self.batch_slots):
                        ev = self._slots[s]
                        if ev is None:
                            continue
                        k = self._key(ev.request_index)
                        if k > head_key and (
                                victim is None or k > victim[1]):
                            victim = (s, k)
                    if victim is None:
                        break
                    vs = victim[0]
                    vev = self._slots[vs]
                    vi = vev.request_index
                    vrid = self._rid(vi)
                    with self._tr.span("preempt", tid=self.trace_tid,
                                       rid=vrid, slot=vs):
                        state = preempt(state, vs, vi)
                    vev.preempted = True
                    self._slots[vs] = None
                    self.preemptions += 1
                    self._resume_streamed[vi] = vev.streamed
                    self._preempted_len[vi] = self._row_len[vs]
                    self._preempted.add(vi)
                    self._tr.end_async("running", vrid)
                    self._tr.begin_async("preempted", vrid, rid=vrid)
                    heapq.heappush(self._pending, self._key(vi))
                if not can_admit(i):
                    break
                free_slot = next(s for s in range(self.batch_slots)
                                 if self._slots[s] is None)
            heapq.heappop(self._pending)
            # stamp before admit(): prefill cost is service, not
            # queueing; a resumed request keeps its first admission
            # stamp (eviction is service disruption, not queueing)
            self._admit_t[free_slot] = \
                self._first_admit_t.setdefault(i, clock())
            rid = self._rid(i)
            resumed = i in self._preempted
            self._tr.end_async("preempted" if resumed else "queued", rid)
            self._preempted.discard(i)
            self._tr.begin_async("running", rid, rid=rid, slot=free_slot,
                                 resumed=resumed)
            try:
                with self._tr.span("admit", tid=self.trace_tid, rid=rid,
                                   slot=free_slot, resumed=resumed):
                    state = admit(state, free_slot, i)
            except Exception as exc:  # noqa: BLE001 — containment seam
                # the failure is the admitted request's alone: release
                # whatever partial pool state admission left behind
                # (exactly-once release machinery makes this safe), fail
                # the request, and keep admitting the rest of the wave
                self.failed[i] = exc
                self._resume_streamed.pop(i, None)
                self._preempted_len.pop(i, None)
                self._first_admit_t.pop(i, None)
                self._tr.end_async("running", rid, failed=True)
                self._tr.instant("failed", tid=self.trace_tid, rid=rid,
                                 where="admit", error=type(exc).__name__)
                if release is not None:
                    state = release(state, free_slot, i)
                if on_fail is not None:
                    state = on_fail(state, free_slot, i, exc)
                continue
            self._row_len[free_slot] = self._preempted_len.pop(
                i, self.requests[i].prompt.size)
            ev = SlotEvent(request_index=i, slot=free_slot,
                           admit_step=self.steps,
                           streamed=self._resume_streamed.pop(i, 0))
            self._slots[free_slot] = ev
            self._record_admit(ev)

        if self._pending and all(ev is None for ev in self._slots):
            # every slot idle yet the head was denied: it can never be
            # admitted (e.g. demand larger than the whole pool).  Fail
            # it — terminal, carrying the reason — instead of wedging
            # the lane behind an unservable request; the wave resumes
            # next tick.  (One per tick keeps the drain bound honest.)
            i = heapq.heappop(self._pending)[-1]
            state = self._fail_unqueued(
                state, i,
                RuntimeError(
                    f"request {i} rejected by can_admit with every slot "
                    "idle — it can never be served"),
                on_fail=on_fail)

        occupied = [s for s in range(self.batch_slots)
                    if self._slots[s] is not None]
        t_step = clock()
        try:
            with self._tr.span("decode", tid=self.trace_tid, step=self.steps,
                               rows=len(occupied)):
                state = step(state)
                # the one host read of the tick; it waits for the card, so
                # the step time covers the device's work too
                with self._tr.span("step.read", tid=self.trace_tid, device=True):
                    host = host_view(state)
                    self._tr.anchor()
                if guard is not None:
                    with self._tr.span("step.guard", tid=self.trace_tid):
                        state, host = guard(state, host)
        except RequestFault as rf:
            # attributable step failure: adopt the coherent state the
            # raiser carries (when it has one) and fail only the named
            # slots; everyone else continues next tick
            self.steps += 1
            if rf.state is not None:
                state = rf.state
            cause = rf.cause if rf.cause is not None else rf
            slots = rf.slots if rf.slots is not None else list(occupied)
            for s in slots:
                if self._slots[s] is not None:
                    state = self.fail_running(state, s, cause,
                                              release=release,
                                              on_fail=on_fail)
            return state, []
        except Exception as exc:  # noqa: BLE001 — containment seam
            # unattributable step failure: the batch step is
            # all-or-nothing, so conservatively fail every occupied
            # slot (their blocks release exactly-once; queued and
            # preempted requests are untouched)
            self.steps += 1
            for s in occupied:
                if self._slots[s] is not None:
                    state = self.fail_running(state, s, exc,
                                              release=release,
                                              on_fail=on_fail)
            return state, []
        step_s = clock() - t_step
        self.steps += 1
        lengths, targets = host["length"], host["target"]
        if occupied:
            accepted = []
            for s in occupied:
                cur = int(min(lengths[s], targets[s]))
                accepted.append(max(0, cur - self._row_len[s]))
                self._row_len[s] = cur
            if self.on_step_stats is not None:
                self.on_step_stats(accepted, step_s, sum(accepted))
        tokens_np = host["tokens"]
        if on_tokens is not None:
            with self._tr.span("stream", tid=self.trace_tid):
                for s in occupied:
                    ev = self._slots[s]
                    P = self.requests[ev.request_index].prompt.size
                    committed = int(min(lengths[s], targets[s])) - P
                    if committed > ev.streamed:
                        on_tokens(ev.request_index,
                                  tokens_np[s, P + ev.streamed:
                                            P + committed].copy())
                        ev.streamed = committed

        done = [s for s in occupied if lengths[s] >= targets[s]]
        harvested: List[int] = []
        if done:
            now = clock()
            commits, row_steps = host["commits"], host["row_steps"]
            with self._tr.span("harvest", tid=self.trace_tid,
                               rows=len(done)):
                for s in done:
                    ev = self._slots[s]
                    ev.harvest_step = self.steps
                    i = ev.request_index
                    r = self.requests[i]
                    P = r.prompt.size
                    self.results[i] = RequestResult(
                        request=r,
                        tokens=tokens_np[s, P: P + r.max_new_tokens].copy(),
                        prompt_len=P,
                        accept_len=float(commits[s])
                        / max(int(row_steps[s]), 1),
                        steps=int(row_steps[s]),
                        queue_s=self._admit_t[s] - self._arrival_t[i],
                        service_s=now - self._admit_t[s],
                        bad=bool(host["bad"][s]),
                    )
                    harvested.append(i)
                    self._first_admit_t.pop(i, None)
                    self._tr.end_async("running", self._rid(i),
                                       tokens=int(r.max_new_tokens),
                                       steps=int(row_steps[s]))
                    if self.on_event is not None:
                        self.on_event(ev)
                    if release is not None:
                        state = release(state, s, i)
                    self._slots[s] = None
        return state, harvested

    # ------------------------------------------------------------------
    # Failure containment (terminal `failed` state)
    # ------------------------------------------------------------------
    def _fail_unqueued(self, state, i: int, exc: BaseException, *,
                       on_fail=None):
        """Record request ``i`` (already removed from the pending heap)
        as failed and fire the containment hook."""
        rid = self._rid(i)
        self.failed[i] = exc
        phase = "preempted" if i in self._preempted else "queued"
        self._preempted.discard(i)
        self._preempted_len.pop(i, None)
        self._resume_streamed.pop(i, None)
        self._first_admit_t.pop(i, None)
        self._tr.end_async(phase, rid, failed=True)
        self._tr.instant("failed", tid=self.trace_tid, rid=rid,
                         where="queue", error=type(exc).__name__)
        if on_fail is not None:
            state = on_fail(state, None, i, exc)
        return state

    def fail_pending(self, state, i: int, exc: BaseException, *,
                     on_fail=None):
        """Fail a still-queued (or preempted-and-requeued) request:
        remove it from the pending heap and record the terminal
        ``failed`` state.  The serving front-end drives client cancels
        and queue timeouts through this.  Returns the (unchanged
        engine) state, for symmetry with :meth:`fail_running`."""
        keep = [k for k in self._pending if k[-1] != i]
        if len(keep) == len(self._pending):
            raise KeyError(f"request {i} is not pending")
        heapq.heapify(keep)
        self._pending = keep
        return self._fail_unqueued(state, i, exc, on_fail=on_fail)

    def fail_running(self, state, slot: int, exc: BaseException, *,
                     release=None, on_fail=None):
        """Fail the request occupying ``slot``: record the terminal
        state, stream the audit event, release its blocks (``release``
        hook — exactly-once safe) and idle the slot.  Used by the tick's
        step containment and by the front-end's running-request
        timeout/cancel paths."""
        ev = self._slots[slot]
        if ev is None:
            raise KeyError(f"slot {slot} is idle")
        i = ev.request_index
        rid = self._rid(i)
        self.failed[i] = exc
        ev.harvest_step = self.steps
        ev.failed = True
        self._first_admit_t.pop(i, None)
        self._tr.end_async("running", rid, failed=True)
        self._tr.instant("failed", tid=self.trace_tid, rid=rid,
                         where="slot", error=type(exc).__name__)
        if self.on_event is not None:
            self.on_event(ev)
        if release is not None:
            state = release(state, slot, i)
        if on_fail is not None:
            state = on_fail(state, slot, i, exc)
        self._slots[slot] = None
        return state

    def pending_indices(self) -> List[int]:
        """Request indices currently queued (including preempted ones
        waiting to resume), in no particular order."""
        return [k[-1] for k in self._pending]

    def find_slot(self, i: int) -> Optional[int]:
        """Slot currently held by request ``i`` (None if not running)."""
        for s, ev in enumerate(self._slots):
            if ev is not None and ev.request_index == i:
                return s
        return None

    # ------------------------------------------------------------------
    def run(
        self,
        state: dict,
        *,
        admit: Callable[[dict, int, int], dict],
        step: Callable[[dict], dict],
        t0: Optional[float] = None,
        can_admit: Optional[Callable[[int], bool]] = None,
        release: Optional[Callable[[dict, int, int], dict]] = None,
        preempt: Optional[Callable[[dict, int, int], dict]] = None,
        on_tokens: Optional[Callable[[int, np.ndarray], None]] = None,
        on_fail: Optional[
            Callable[[dict, Optional[int], int, BaseException], dict]] = None,
    ) -> tuple:
        """Drive the loop until the queue drains.

        Lifecycle hooks (all host-side callables):

        * ``admit(state, slot, request_index) -> state`` — **required**.
          Must return the state with ``slot`` prefilled for the request
          (every per-row slice reset; see
          ``SpecEngine.prefill_into_slot``).  Called whenever a slot is
          free and the pending queue is non-empty.
        * ``step(state) -> state`` — **required**.  Advances the whole
          batch one verify step (the engine's decode step, plus
          any host-side bookkeeping such as paged block appends).
        * ``can_admit(request_index) -> bool`` — optional admission
          gate, consulted for the *head* of the priority queue before
          each admission.  A ``False`` stops this wave's admissions
          (head-of-line blocking — a denied high-priority request is
          never overtaken by a cheaper one, so priority order and
          token-stream invariance are preserved).  The paged KV engine
          uses this to admit only requests whose worst-case block
          demand fits the pool.
        * ``release(state, slot, request_index) -> state`` — optional
          harvest hook, called after a finished request's result is
          recorded and before the slot is marked free.  The paged KV
          engine returns the request's cache blocks to the pool here
          **and resets the slot's block-table row to scratch** — an idle
          row keeps stepping, and its (discarded) window writes must not
          land in blocks the free list may hand to the next admission.
        * ``preempt(state, slot, request_index) -> state`` — optional
          eviction hook.  When the queue head is denied by
          ``can_admit``, running occupants whose admission key is
          *strictly worse* than the head's are evicted worst-first
          (``PagedGroup.preempt`` swaps their blocks to host memory)
          until the head fits; evicted requests re-enter the pending
          queue with their original keys and resume bit-exactly via
          ``admit``.  The strict-key rule guarantees progress: a
          request can only be displaced by a strictly better one, so
          preemption chains terminate.  In the batch :meth:`run` mode
          admissions already pop in key order, so every occupant's key
          is better than any pending head's and the hook structurally
          never fires — it exists for the open-loop front-end
          (the reference's ``serving/server.py``) where better-keyed requests arrive
          while worse ones hold slots.
        * ``on_tokens(request_index, tokens)`` — optional per-request
          streaming callback (see :meth:`tick`).

        ``t0`` is the arrival timestamp the requests' ``queue_s`` is
        measured from (``time.perf_counter`` clock) — callers serving
        several scheduler loops sequentially pass the call-level start so
        later loops report the full wait.  A request ``can_admit``
        permanently rejects while every slot is idle (one that can
        never be served) transitions to the terminal ``failed`` state —
        its entry in the returned results is ``None`` and ``failed``
        carries the reason.  Returns ``(state, results)`` with
        ``results`` in request order.
        """
        t0 = time.perf_counter() if t0 is None else t0
        self._arrival_t = [t0] * len(self.requests)
        # hard safety: every active row commits >= 1 token per step, so
        # the loop is bounded by the total token budget (+ slack per wave)
        max_steps = sum(r.max_new_tokens for r in self.requests) \
            + 8 * (len(self.requests) + self.batch_slots) + 8

        while self.busy:
            state, _ = self.tick(
                state, admit=admit, step=step, can_admit=can_admit,
                release=release, preempt=preempt, on_tokens=on_tokens,
                on_fail=on_fail)
            if self.steps > max_steps:
                stuck = [ev.request_index for ev in self._slots
                         if ev is not None]
                raise RuntimeError(
                    f"scheduler failed to drain: {len(self._pending)} "
                    f"pending, slots stuck on requests {stuck} after "
                    f"{self.steps} steps")
        return state, [self.results.get(i)
                       for i in range(len(self.requests))]
