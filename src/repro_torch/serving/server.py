"""Async streaming serving front-end: SLO-aware admission over the
continuous-batching scheduler — port of ``repro/serving/server.py``.

The engine below this layer is batch-synchronous: ``generate_requests``
blocks until a fixed request list drains.  A server faces an *open* loop
— requests arrive continuously, each with its own latency SLO.  This
module adds that loop as a layer **above** the engine, reusing the
scheduler's admit → step → harvest machinery unchanged:

* :class:`ServingLoop` — the single-threaded core.  An ingestion queue
  feeds per-(temperature, lane) :class:`Scheduler` instances (temperature
  is a constant of the decode step, so each lane owns one step program
  and one state whose tensors it keeps); :meth:`ServingLoop.poll` routes
  arrivals, sheds queued work whose deadline already passed, and advances
  each busy lane one decode step, forwarding newly-committed tokens to
  the per-request :class:`StreamHandle` as they commit.  The clock is
  injectable, so a load replay drives the same code on a virtual clock.
* :class:`StreamingServer` — the asynchronous front: a background thread
  polls the loop while callers ``submit()`` from any thread and consume
  ``handle.tokens()`` / ``handle.result()`` concurrently.  Requests and
  results are numpy: the callers' threads make no call on the card, and
  the loop's thread captures its step programs in ``"thread_local"``
  error mode (``serving/graphs.py``).

SLO-aware admission, in order of application: **EDF within priority
class** (``admission="edf"``; it shifts only *when* a request is
admitted, per-request generators keep its tokens); **shedding**
(``shed_late``: a queued request past its deadline is dropped, never a
running one); **degrade tree → chain** (``degrade_on_overload``: under a
backlog new arrivals of a tree-drafting engine go to a chain lane; at
T = 0 the tokens are the same, lossless drafting).

**Failure containment** (the reference's ``docs/robustness.md``): every
request ends in exactly one of ``done | shed | failed``, and
``completed + shed + failed == submitted``.  The verify path runs under a
NaN/Inf guardrail (:meth:`_Lane._guard`: retry, then the bf16 fallback
lane, then fail the rows) and an acceptance-collapse detector; the
:class:`StreamingServer` thread runs under a supervisor that restarts the
loop with capped backoff.  ``repro_torch.serving.faults`` injects
deterministic faults at every seam.

Where the port differs from the reference:

* **The guardrail reruns an in-place step.**  The reference's step is
  pure, so its guard reruns from the intact input.  The port's step writes
  the state's own tensors (which its CUDA graph needs), so each lane takes
  a :class:`~repro_torch.serving.engine.StepSnapshot` of the small per-row
  registers before every step and restores it in place on a trip; the
  bf16 rescue keeps the retry's registers and window KV for the rows it
  does not rescue and writes them back after the fallback step.  The guard
  reads ``bad`` from the tick's one host read (``Scheduler.tick(guard=)``)
  and syncs again only on a trip.
* **Programs per params object.**  A poisoned view (``nan_verify``,
  ``quant_corrupt``) and a lane repair make new params objects; the port
  builds a program for each (``step_traces`` counts it), where the
  reference's ``jit`` reuses its trace.  A degrade lane's engine shares
  the primary engine's prepared params (the same verifier prepares them
  identically) instead of preparing a second copy.
* **Admission is stamped before the prefill.**  ``ServerMetrics.on_admit``
  gets the time the admission began (reported once it holds), so the
  metrics' queue wait equals the scheduler's ``queue_s``; the reference
  stamps it after the prefill.

With ``SpecConfig(kv_layout="paged")`` each lane owns a block pool sized
for its slot count's worst-case demand, a prefix-cache index and a host
swap pool (``serving/engine.PagedGroup``).  Attention-family archs only
(the lane pads prompts to ``max_prompt_len``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.paged_cache import (
    blocks_for_tokens,
    init_paged_cache,
    request_demand_tokens,
)
from repro_torch.core.spec_engine import init_state
from repro_torch.serving.engine import SpecEngine, StepSnapshot
from repro_torch.serving.faults import (
    NULL_FAULTS,
    InjectedFault,
    LaneCrashed,
    RequestCancelled,
    RequestFault,
    RequestTimeout,
    VerifierNaNError,
    poison_params,
)
from repro_torch.serving.metrics import ServerMetrics
from repro_torch.serving.request import GenerationRequest, RequestResult
from repro_torch.serving.scheduler import Scheduler, host_view
from repro_torch.serving.trace import NULL_TRACER

_MAX_LANES = 8          # distinct (temperature, degraded) decode loops


@dataclass(frozen=True)
class ServerConfig:
    """Serving front-end policy knobs (engine knobs live in SpecConfig)."""

    batch_slots: int = 4               # decode rows per lane
    max_prompt_len: int = 64           # admission caps: they fix the
    max_new_tokens: int = 64           # lane's buffer sizes
    admission: str = "edf"             # "edf" | "fifo"
    shed_late: bool = True             # drop queued past-deadline work
    shed_slack_s: float = 0.0          # pre-shed margin (est. min service)
    degrade_on_overload: bool = False  # tree -> chain lane under pressure
    degrade_drafter: str = "ngram"     # chain drafter for the degraded lane
    overload_factor: float = 2.0       # pending > factor*slots = overload
    max_events: Optional[int] = 1024   # scheduler audit-trail cap per lane
    request_timeout_s: Optional[float] = None  # end-to-end per-request cap
    #                                    (queued + running); None = no cap
    collapse_window: int = 0           # acceptance-collapse detector: steps
    #                                    in the sliding window (0 disables)
    collapse_threshold: float = 0.05   # mean accepted tokens/row-step below
    #                                    which a full window trips a lane
    #                                    repair (re-quantize the params)

    def __post_init__(self):
        if self.admission not in ("fifo", "edf"):
            raise ValueError(f"unknown admission {self.admission!r}")
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if self.request_timeout_s is not None \
                and not self.request_timeout_s > 0.0:
            raise ValueError("request_timeout_s must be positive (or None)")
        if self.collapse_window < 0:
            raise ValueError("collapse_window must be >= 0")


_EOS = None                            # stream terminator sentinel


class StreamHandle:
    """Caller-side view of one in-flight request.

    * :meth:`tokens` — blocking iterator over newly-committed token deltas
      (``np.int32`` arrays); ends when the request reaches any terminal
      state.  Safe to consume from another thread than the server's.
    * :attr:`chunks` — the deltas so far (non-blocking);
      ``np.concatenate(chunks)`` is bit-identical to ``result().tokens``.
    * :meth:`result` — blocks until a terminal state; returns the
      :class:`RequestResult`, ``None`` if the request was shed, or
      **re-raises** the terminal exception if it ``failed`` (also on
      :attr:`error`).
    * :meth:`cancel` — thread-safe, idempotent, best-effort cancellation
      (``failed`` with ``RequestCancelled`` unless already terminal).
    * :attr:`status` — ``queued | running | done | shed | failed``.
    """

    def __init__(self, rid: int, request: GenerationRequest,
                 submit_t: float, deadline_t: Optional[float],
                 loop: Optional["ServingLoop"] = None):
        self.rid = rid
        self.request = request
        self.submit_t = submit_t
        self.deadline_t = deadline_t
        self.status = "queued"
        self.degraded = False
        self.error: Optional[BaseException] = None
        self.chunks: List[np.ndarray] = []
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._done = threading.Event()
        self._result: Optional[RequestResult] = None
        self._loop = loop
        self._lane: Optional["_Lane"] = None   # routing target (loop thread)
        self._idx: Optional[int] = None        # scheduler-local index
        self._routed = False                   # metrics submit fired once
        self._reject: Optional[BaseException] = None  # submit validation
        self._cancelled = False

    def tokens(self):
        while True:
            item = self._q.get()
            if item is _EOS:
                return
            yield item

    def result(self, timeout: Optional[float] = None
               ) -> Optional[RequestResult]:
        if not self._done.wait(timeout):
            loop = self._loop
            if loop is not None and loop.dead is not None:
                raise TimeoutError(
                    f"request {self.rid} will never finish: the serving "
                    f"loop is dead ({type(loop.dead).__name__})"
                ) from loop.dead
            raise TimeoutError(
                f"request {self.rid} still {self.status} after {timeout}s")
        if self.error is not None:
            raise self.error
        return self._result

    def cancel(self) -> None:
        """Ask the loop to fail this request with ``RequestCancelled`` at
        its next poll (no-op once terminal)."""
        self._cancelled = True
        loop = self._loop
        if loop is not None:
            loop._control.put(self)

    def collected(self) -> np.ndarray:
        """All streamed tokens so far, concatenated (non-blocking)."""
        if not self.chunks:
            return np.zeros((0,), np.int32)
        return np.concatenate(self.chunks)

    # loop-side -------------------------------------------------------
    def _emit(self, toks: np.ndarray) -> None:
        self.chunks.append(toks)
        self._q.put(toks)

    def _finish(self, result: Optional[RequestResult], status: str,
                error: Optional[BaseException] = None) -> None:
        self._result = result
        self.error = error
        self.status = status
        self._q.put(_EOS)
        self._done.set()


class _Lane:
    """One decode loop: a Scheduler + a state whose tensors it keeps, for
    one (temperature, degraded?) combination."""

    def __init__(self, loop: "ServingLoop", engine: SpecEngine, temperature: float,
                 tid: int = 0):
        cfg = loop.cfg
        self.loop = loop
        self.tid = tid                         # tracer track for this lane
        self.engine = engine
        self.temperature = temperature
        # the degrade engine shares the primary's verifier, so the primary's
        # prepared params serve both
        self.params = loop.engine._prepare_cached(loop._raw_params)
        self.step, self.drafter = engine._step_for_temperature(temperature)
        self.key = f"{self.drafter.name}:{engine.verifier.name}"
        # guardrail state: the raw (unprepared) params feed the bf16
        # fallback step and lane repairs; the fallback step is built on
        # the first trip
        self.fallback_params = loop._raw_params
        self.fallback_step = None
        self._bf16_streak = 0
        self._collapse_hist = (
            collections.deque(maxlen=cfg.collapse_window)
            if cfg.collapse_window else None)
        self.buf = (cfg.max_prompt_len + cfg.max_new_tokens
                    + self.drafter.gamma + 2)
        # one padded prompt length per lane: requests shorter than the cap
        # are right-padded exactly as generate_requests pads a group
        self.pmax = cfg.max_prompt_len
        slots = cfg.batch_slots

        def on_step_stats(accepted, step_s, n_tokens, _key=self.key):
            loop.metrics.on_decode_step(_key, accepted, step_s)
            engine.telemetry.on_decode_step(_key, accepted, step_s)
            if self._collapse_hist is not None and accepted:
                self._note_acceptance(sum(accepted) / len(accepted))

        self.sched = Scheduler(
            [], slots, policy=cfg.admission, max_events=cfg.max_events,
            on_event=loop.metrics.on_slot_event,
            tracer=loop.tracer, trace_tid=tid,
            on_step_stats=on_step_stats)
        self.ctx = None                        # paged: PagedGroup context
        cache = None
        scfg = engine.scfg
        dev = engine.model.device
        if scfg.kv_layout == "paged":
            engine._check_paged_supported()
            bs = scfg.kv_block_size
            # one pool per lane, sized so `slots` worst-case requests at the
            # server's caps co-reside (+1 COW headroom each when prefix
            # sharing may donate boundary blocks, +1 scratch)
            demand_cap = blocks_for_tokens(
                request_demand_tokens(cfg.max_prompt_len,
                                      cfg.max_new_tokens,
                                      self.drafter.gamma), bs)
            per = demand_cap + (1 if scfg.kv_prefix_sharing else 0)
            num_blocks = (scfg.kv_pool_blocks
                          if scfg.kv_pool_blocks is not None
                          else 1 + slots * per)
            if demand_cap > num_blocks - 1:
                raise ValueError(
                    f"kv_pool_blocks={num_blocks} cannot hold even one "
                    f"worst-case request ({demand_cap} blocks at the "
                    "server's prompt/budget caps)")
            max_blocks = blocks_for_tokens(self.buf, bs)
            cache = init_paged_cache(engine.model.cfg, slots, max_blocks,
                                     num_blocks, bs, device=dev)
            self.ctx = engine.paged_group(num_blocks=num_blocks,
                                          block_size=bs,
                                          gamma=self.drafter.gamma,
                                          tracer=loop.tracer,
                                          trace_tid=tid,
                                          faults=loop.faults)
        self.state = init_state(
            engine.model, slots, self.buf, prng.row_generators([0] * slots, dev),
            drafter_state=self.drafter.alloc_state(
                engine.model, self.params, slots, self.buf),
            target=torch.zeros((slots,), dtype=torch.int32),
            cache=cache)
        # the guardrail's pre-step state (registers; the step's KV writes
        # are positional) and, on the fallback path, the retry's
        self.pre = StepSnapshot(self.state, self.drafter.gamma + 1)
        self._retry: Optional[StepSnapshot] = None
        self.handles: Dict[int, StreamHandle] = {}   # lane index -> handle

    def on_submit(self, i: int, handle: StreamHandle) -> None:
        self.handles[i] = handle
        if self.ctx is not None:
            self.ctx.register(i, handle.request)

    def admit(self, state: dict, slot: int, i: int) -> dict:
        h = self.handles[i]
        h.status = "running"
        if self.ctx is not None:
            return self.ctx.admit(state, slot, i, params=self.params,
                                  pmax=self.pmax, drafter=self.drafter)
        return self.engine.prefill_into_slot(
            self.params, state, slot, h.request,
            pmax=self.pmax, drafter=self.drafter)

    def step_fn(self, state: dict) -> dict:
        loop = self.loop
        faults = loop.faults
        params = self.params
        if faults.enabled:
            if faults.fire("step", lane=self.tid):
                raise InjectedFault(
                    f"injected step failure (lane {self.tid})")
            if faults.fire("quant_corrupt", lane=self.tid):
                # sticky: the lane's *prepared* params are poisoned, as a
                # real quantization corruption would be — every later step
                # reproduces it until the guardrail repairs the lane
                self.params = params = poison_params(self.params)
            if faults.fire("nan_verify", lane=self.tid):
                # transient: poison only this step's local view
                params = poison_params(self.params)
        tr = loop.tracer
        if self.ctx is not None:
            with tr.span("step.prepare", tid=self.tid, device=True):
                state = self.ctx.prepare_step(state)
        with tr.span("step.snapshot", tid=self.tid):
            self.pre.take(state)       # the step writes in place
        with tr.span("step.launch", tid=self.tid, device=True):
            state = self.step(params, state)
        # fires inside the scheduler's "decode" span: a virtual-clock
        # driver advances time here
        if loop.step_hook is not None:
            loop.step_hook()
        if faults.enabled:
            d = faults.delay("stall")
            if d > 0.0:
                # slow/hung tick: request_timeout_s is the containment
                loop._stall(d)
        return state

    def _guard(self, state: dict, host: dict) -> Tuple[dict, dict]:
        """Verify-path NaN/Inf guardrail, on the tick's host read.

        The step folds a per-row non-finite-logits flag into
        ``stats["bad"]``.  When any *occupied* row trips, escalate through
        a three-stage ladder, each stage rerunning from the pre-step state
        (:attr:`pre`, restored in place):

        1. **same-precision retry** — a transient fault replays to the
           exact fault-free output (per-request generators make the
           retried step bit-identical to an untripped one);
        2. **full-precision fallback** — the bf16 twin of this lane's step
           on the *raw* params rescues persistent quantized-weight
           corruption losslessly.  Rescued rows keep the fallback's
           values, every other row gets the retry's back (registers and
           window KV, in place); their requests are recorded in
           ``loop.affected``; three consecutive bf16-rescued steps trigger
           a lane repair (re-prepare the params from the raw tree);
        3. rows still non-finite under bf16 are unrescuable: **fail
           exactly those requests** via :class:`RequestFault`.

        Returns the state (the same tensors) and its host view, read again
        only after a trip.
        """
        bad = host["bad"]
        sched = self.sched
        rows = [s for s in range(sched.batch_slots)
                if bad[s] and sched._slots[s] is not None]
        if not rows:
            self._bf16_streak = 0
            return state, host
        loop = self.loop
        loop.metrics.on_guardrail("verify_nan_trips")
        with loop.tracer.span("guardrail", tid=self.tid, rows=len(rows)):
            self.pre.restore(state)
            self.step(self.params, state)
            host = host_view(state)
            still = [s for s in rows if host["bad"][s]]
            if len(still) < len(rows):
                loop.metrics.on_guardrail("retry_rescued_rows",
                                          len(rows) - len(still))
            if not still:
                self._bf16_streak = 0
                return state, host
            if self.fallback_step is None:
                self.fallback_step = self.engine.fallback_step_for(
                    self.temperature)
            if self._retry is None:
                self._retry = StepSnapshot(state, self.pre.window)
            retry = self._retry
            retry.take(state)
            retry.take_window(state, self.pre.length)
            self.pre.restore(state)
            self.fallback_step(self.fallback_params, state)
            fbad = host_view(state)["bad"]
            saved = [s for s in still if not fbad[s]]
            doomed = [s for s in still if fbad[s]]
            retry.restore(state, [s for s in range(sched.batch_slots) if s not in saved])
            host = host_view(state)
            if saved:
                loop.metrics.on_guardrail("bf16_rescued_rows", len(saved))
                for s in saved:
                    h = self.handles.get(sched._slots[s].request_index)
                    if h is not None:
                        loop.affected.add(h.rid)
                self._bf16_streak += 1
                if self._bf16_streak >= 3:
                    # the quantized weights themselves are the prime
                    # suspect: re-quantizing from the raw tree clears real
                    # and injected corruption alike
                    self.params = self.engine.prepare_params(
                        self.fallback_params)
                    self._bf16_streak = 0
                    loop.metrics.on_guardrail("reprepares")
            if doomed:
                loop.metrics.on_guardrail("unrescued_rows", len(doomed))
                raise RequestFault(
                    f"verifier logits non-finite for slots {doomed} even "
                    "through the full-precision fallback",
                    slots=doomed, state=state,
                    cause=VerifierNaNError(
                        "non-finite verifier logits survived retry and "
                        "bf16 fallback (suspect corrupted KV state)"))
        return state, host

    def _note_acceptance(self, mean_accept: float) -> None:
        """Acceptance-collapse detector: quantized-weight damage that does
        NOT produce NaNs still shows up as acceptance falling to ~zero.
        When the whole sliding window sits below ``collapse_threshold`` on
        a quantized-verifier lane, trip a lane repair and reset."""
        hist = self._collapse_hist
        hist.append(mean_accept)
        if len(hist) < hist.maxlen:
            return
        if sum(hist) / len(hist) >= self.loop.cfg.collapse_threshold:
            return
        self.loop.metrics.on_guardrail("collapse_trips")
        hist.clear()
        if self.engine.verifier.name != "bf16":
            self.params = self.engine.prepare_params(self.fallback_params)
            self.loop.metrics.on_guardrail("reprepares")


class ServingLoop:
    """Single-threaded serving core with an injectable clock.

    ``submit()`` is thread-safe (arrivals land on an ingestion queue);
    ``poll()`` must be called from one driving thread — either the
    :class:`StreamingServer` wrapper's background thread (real clock) or a
    replay loop (virtual clock).
    """

    def __init__(self, engine: SpecEngine, params, cfg: ServerConfig = ServerConfig(),
                 *, clock=time.perf_counter,
                 metrics: Optional[ServerMetrics] = None,
                 tracer=None, step_hook=None, faults=None,
                 stall_hook=None):
        if engine.model.cfg.arch_type in ("ssm", "hybrid"):
            raise ValueError(
                f"{engine.model.cfg.arch_type!r} caches are recurrent: "
                "the serving lane right-pads prompts to max_prompt_len, "
                "which recurrent state cannot mask")
        self.engine = engine
        self.cfg = cfg
        self.clock = clock
        self.metrics = metrics if metrics is not None else ServerMetrics()
        # the tracer's clock should match `clock` for coherent timelines;
        # step_hook fires after every decode step (virtual-clock drivers
        # advance time there)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.step_hook = step_hook
        # fault-injection plan (NULL_FAULTS = off) and the stall hook a
        # virtual-clock driver installs so injected slow ticks advance
        # modeled time instead of sleeping
        self.faults = faults if faults is not None else NULL_FAULTS
        self.stall_hook = stall_hook
        # rids whose tokens were (partly) produced by the bf16 fallback
        self.affected: Set[int] = set()
        # terminal error once the supervisor gives up
        self.dead: Optional[BaseException] = None
        self._raw_params = params
        self._ingress: "queue.SimpleQueue" = queue.SimpleQueue()
        self._control: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lanes: Dict[Tuple[float, bool], _Lane] = {}
        self._rid = 0
        self._rid_lock = threading.Lock()
        self.total_steps = 0
        # degraded lane: only meaningful when the primary drafter drafts
        # trees — chain drafting IS the degraded mode
        self._degraded_engine = None
        if cfg.degrade_on_overload \
                and getattr(engine.drafter, "template", None) is not None:
            dscfg = dataclasses.replace(
                engine.scfg, tree_branches=None, drafter=cfg.degrade_drafter)
            self._degraded_engine = SpecEngine(
                engine.model, dscfg, drafter=cfg.degrade_drafter,
                verifier=engine.verifier, graphs=engine._programs.graphs)

    # ------------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return not self._ingress.empty() or any(
            lane.sched.busy for lane in self._lanes.values())

    @property
    def pending(self) -> int:
        return sum(len(lane.sched._pending) for lane in self._lanes.values())

    def submit(self, request: GenerationRequest) -> StreamHandle:
        """Thread-safe ingestion; returns the request's stream handle.

        Never raises for a bad request: one violating the server caps comes
        back as a handle that terminally **fails** at the next poll."""
        now = self.clock()
        with self._rid_lock:
            rid = self._rid
            self._rid += 1
        deadline_t = (None if request.deadline_s is None
                      else now + request.deadline_s)
        handle = StreamHandle(rid, request, now, deadline_t, loop=self)
        msg = request.violation(self.cfg.max_prompt_len,
                                self.cfg.max_new_tokens)
        if msg is not None:
            handle._reject = ValueError(msg)
        if self.dead is not None:
            # no poll will ever run again: resolve here, still counted
            err = LaneCrashed(
                f"serving loop is dead: {type(self.dead).__name__}")
            err.__cause__ = self.dead
            handle._routed = True
            with self._rid_lock:
                self.metrics.on_submit(rid, now, deadline_t=deadline_t)
                self.metrics.on_guardrail("rejected")
                self.metrics.on_failed(rid, now)
            handle._finish(None, "failed", error=err)
            return handle
        self._ingress.put(handle)
        return handle

    # ------------------------------------------------------------------
    def _overloaded(self) -> bool:
        return self.pending >= self.cfg.overload_factor * self.cfg.batch_slots

    def _lane(self, temperature: float, degraded: bool) -> _Lane:
        key = (temperature, degraded)
        lane = self._lanes.get(key)
        if lane is None:
            if len(self._lanes) >= _MAX_LANES:
                raise RuntimeError(
                    f"more than {_MAX_LANES} distinct (temperature, lane) "
                    "combinations — each pins a compiled decode step")
            engine = (self._degraded_engine if degraded else self.engine)
            tid = len(self._lanes)
            lane = _Lane(self, engine, temperature, tid)
            self._lanes[key] = lane
            label = (f"lane{tid} T={temperature:g} {lane.key}"
                     + (" degraded" if degraded else ""))
            self.tracer.thread_name(tid, label)
            if lane.ctx is not None:
                self.metrics.add_kv_source(f"lane{tid}", lane.ctx.snapshot)
        return lane

    def _reject_handle(self, handle: StreamHandle, exc: BaseException,
                       first: bool) -> None:
        """Resolve a handle as terminally failed before it ever reaches a
        scheduler.  ``first`` guards the submitted count: a handle
        re-entering the ingress queue after a recovery is not re-counted."""
        if first:
            self.metrics.on_submit(handle.rid, handle.submit_t,
                                   deadline_t=handle.deadline_t)
        self.metrics.on_guardrail(
            "cancelled" if isinstance(exc, RequestCancelled)
            else "rejected")
        self.metrics.on_failed(handle.rid, self.clock())
        handle._finish(None, "failed", error=exc)

    def _route_ingress(self) -> int:
        routed = 0
        while True:
            try:
                handle = self._ingress.get_nowait()
            except queue.Empty:
                return routed
            routed += 1
            first = not handle._routed
            handle._routed = True
            if handle._reject is None \
                    and self.faults.fire("submit", rid=handle.rid):
                handle._reject = ValueError(
                    f"injected malformed request {handle.rid}")
            if handle._reject is not None:
                self._reject_handle(handle, handle._reject, first)
                continue
            if handle._cancelled:
                self._reject_handle(
                    handle,
                    RequestCancelled(
                        f"request {handle.rid} cancelled before routing"),
                    first)
                continue
            degraded = (self._degraded_engine is not None
                        and self._overloaded())
            handle.degraded = degraded
            t = (self.engine.scfg.temperature
                 if handle.request.temperature is None
                 else float(handle.request.temperature))
            try:
                lane = self._lane(t, degraded)
            except RuntimeError as exc:
                # _MAX_LANES overflow: the request asking for the novel
                # temperature fails alone; existing lanes keep serving
                self._reject_handle(handle, exc, first)
                continue
            idx = lane.sched.submit(
                handle.request, arrival_t=handle.submit_t,
                deadline=handle.deadline_t, trace_id=handle.rid)
            handle._lane = lane
            handle._idx = idx
            lane.on_submit(idx, handle)
            if first:
                self.metrics.on_submit(handle.rid, handle.submit_t,
                                       deadline_t=handle.deadline_t,
                                       degraded=degraded)

    @torch.inference_mode()
    def poll(self) -> bool:
        """One serving iteration: route arrivals, apply cancels and request
        timeouts, shed late queued work, advance every busy lane one decode
        step (streaming tokens as they commit), harvest.  Returns True if
        any lane did work."""
        if self.faults.fire("poll"):
            raise InjectedFault("injected poll failure (supervisor seam)")
        self._route_ingress()
        # client cancels land on a control queue (thread-safe); apply them
        # before admission so a cancelled queued request never takes a slot
        while True:
            try:
                h = self._control.get_nowait()
            except queue.Empty:
                break
            self._cancel_now(h)
        worked = False
        now = self.clock()
        if self.cfg.request_timeout_s is not None:
            self._check_timeouts(now)
        for lane in self._lanes.values():
            if self.cfg.shed_late:
                for i in lane.sched.shed_pending(
                        now, slack=self.cfg.shed_slack_s):
                    h = lane.handles.pop(i)
                    if lane.ctx is not None:
                        # a preempted request re-enters the pending queue
                        # and may be shed while swapped out
                        lane.ctx.drop(i)
                    self.metrics.on_shed(h.rid, now)
                    h._finish(None, "shed")
            if not lane.sched.busy:
                continue
            worked = True

            def on_tokens(i, toks, _lane=lane):
                # after the tick's host read, which waits for the card
                h = _lane.handles[i]
                t_emit = self.clock()
                h._emit(toks)
                self.metrics.on_tokens(h.rid, t_emit, toks.size)

            def admit(st, slot, i, _lane=lane):
                # stamped before the prefill, as the scheduler's queue_s
                # is (the prefill is service, not queueing); reported once
                # the admission holds, so a failed one is never admitted
                t_admit = self.clock()
                st = _lane.admit(st, slot, i)
                self.metrics.on_admit(_lane.handles[i].rid, t_admit)
                return st

            can_admit = release = preempt = None
            if lane.ctx is not None:
                can_admit = lane.ctx.can_admit
                release = lane.ctx.release
                if self.engine.scfg.kv_preempt:
                    preempt = lane.ctx.preempt
            lane.state, harvested = lane.sched.tick(
                lane.state, admit=admit, step=lane.step_fn,
                can_admit=can_admit, release=release, preempt=preempt,
                on_tokens=on_tokens, on_fail=self._make_on_fail(lane),
                clock=self.clock, guard=lane._guard)
            self.total_steps += 1
            busy = sum(ev is not None for ev in lane.sched._slots)
            self.metrics.on_step(self.clock(), busy, lane.sched.batch_slots)
            self.tracer.counter("occupancy", busy, tid=lane.tid)
            if lane.ctx is not None:
                self.tracer.counter("free_blocks",
                                    lane.ctx.pool.free_blocks, tid=lane.tid)
            for i in harvested:
                h = lane.handles.pop(i)
                self.metrics.on_finish(h.rid, self.clock())
                h._finish(lane.sched.results[i], "done")
        return worked

    def drain(self, max_polls: int = 10_000_000) -> None:
        """Poll until every submitted request reached a terminal state."""
        polls = 0
        while self.busy:
            self.poll()
            polls += 1
            if polls > max_polls:
                raise RuntimeError("ServingLoop.drain: poll budget exhausted")

    # -- failure containment ---------------------------------------------
    def _stall(self, seconds: float) -> None:
        """Model a slow/hung tick: virtual-clock drivers advance their
        clock via ``stall_hook``; a real server genuinely sleeps."""
        if self.stall_hook is not None:
            self.stall_hook(seconds)
        else:
            time.sleep(seconds)

    def _make_on_fail(self, lane: _Lane):
        """Scheduler ``on_fail`` hook for ``lane``: by the time it fires the
        scheduler has recorded the terminal state and run ``release``; this
        idles the engine row, drops paged bookkeeping and resolves the
        caller-facing handle."""
        def on_fail(st, slot, i, exc, _lane=lane):
            h = _lane.handles.pop(i, None)
            if slot is not None:
                # a dead request must stop decoding: zero the row's
                # length/target in place (the next admit re-prefills both)
                st["length"][slot] = 0
                st["target"][slot] = 0
            if _lane.ctx is not None:
                _lane.ctx.drop(i)
            if h is not None:
                if isinstance(exc, RequestCancelled):
                    self.metrics.on_guardrail("cancelled")
                elif isinstance(exc, RequestTimeout):
                    self.metrics.on_guardrail("timeouts")
                else:
                    self.metrics.on_guardrail("request_faults")
                self.metrics.on_failed(h.rid, self.clock())
                h._finish(None, "failed", error=exc)
            return st
        return on_fail

    def _cancel_now(self, h: StreamHandle) -> None:
        """Apply a queued cancel request (loop thread only)."""
        if h.status in ("done", "shed", "failed"):
            return
        lane = h._lane
        if lane is None:
            # still in the ingress queue: routing fails it on arrival
            return
        i = h._idx
        exc = RequestCancelled(f"request {h.rid} cancelled by client")
        onf = self._make_on_fail(lane)
        slot = lane.sched.find_slot(i)
        if slot is not None:
            release = lane.ctx.release if lane.ctx is not None else None
            lane.state = lane.sched.fail_running(
                lane.state, slot, exc, release=release, on_fail=onf)
        elif i in lane.sched.pending_indices():
            lane.state = lane.sched.fail_pending(
                lane.state, i, exc, on_fail=onf)

    def _check_timeouts(self, now: float) -> None:
        """Fail every request older end-to-end than ``request_timeout_s``,
        queued or running."""
        cut = self.cfg.request_timeout_s
        for lane in self._lanes.values():
            onf = self._make_on_fail(lane)
            for i in lane.sched.pending_indices():
                h = lane.handles.get(i)
                if h is not None and now - h.submit_t > cut:
                    lane.state = lane.sched.fail_pending(
                        lane.state, i,
                        RequestTimeout(
                            f"request {h.rid} exceeded "
                            f"request_timeout_s={cut} while queued"),
                        on_fail=onf)
            release = lane.ctx.release if lane.ctx is not None else None
            for s in range(lane.sched.batch_slots):
                ev = lane.sched._slots[s]
                if ev is None:
                    continue
                h = lane.handles.get(ev.request_index)
                if h is not None and now - h.submit_t > cut:
                    lane.state = lane.sched.fail_running(
                        lane.state, s,
                        RequestTimeout(
                            f"request {h.rid} exceeded "
                            f"request_timeout_s={cut} while running"),
                        release=release, on_fail=onf)

    def _teardown(self) -> None:
        """Drop every lane, and the step programs built on its state."""
        for lane in self._lanes.values():
            lane.engine.forget_state(lane.state)
        self._lanes.clear()

    def recover(self, exc: BaseException) -> None:
        """Containment after an exception escaped :meth:`poll` (the
        supervisor path): running requests fail, queued handles re-enter the
        ingress queue, and all lanes are torn down with their programs — the
        next poll rebuilds them.  Requeued work is not re-counted."""
        requeue: List[StreamHandle] = []
        for lane in self._lanes.values():
            for i, h in list(lane.handles.items()):
                if h.status == "running":
                    err = LaneCrashed(
                        f"serving lane crashed under request {h.rid}: "
                        f"{type(exc).__name__}")
                    err.__cause__ = exc
                    self.metrics.on_guardrail("request_faults")
                    self.metrics.on_failed(h.rid, self.clock())
                    h._finish(None, "failed", error=err)
                else:
                    # still queued: nothing of it lives on the card yet
                    requeue.append(h)
            lane.handles.clear()
        self._teardown()
        for h in requeue:
            h._lane = h._idx = None
            self._ingress.put(h)

    def abort(self, exc: BaseException) -> None:
        """Terminal failure: mark the loop dead and fail everything in
        flight.  Nothing hangs; conservation still holds."""
        self.dead = exc
        while True:
            try:
                h = self._ingress.get_nowait()
            except queue.Empty:
                break
            if not h._routed:
                h._routed = True
                self.metrics.on_submit(h.rid, h.submit_t,
                                       deadline_t=h.deadline_t)
            self.metrics.on_guardrail("request_faults")
            self.metrics.on_failed(h.rid, self.clock())
            h._finish(None, "failed", error=exc)
        for lane in self._lanes.values():
            for i, h in list(lane.handles.items()):
                self.metrics.on_guardrail("request_faults")
                self.metrics.on_failed(h.rid, self.clock())
                h._finish(None, "failed", error=exc)
            lane.handles.clear()
        self._teardown()

    @torch.inference_mode()
    def shutdown(self) -> None:
        """Deterministic non-drain teardown: queued work is shed, running
        work fails with ``RequestCancelled``.  The loop ends idle with
        conservation intact; it is NOT dead (submit keeps working)."""
        self._route_ingress()
        now = self.clock()
        for lane in self._lanes.values():
            onf = self._make_on_fail(lane)
            for i in lane.sched.shed_pending(math.inf):
                h = lane.handles.pop(i)
                if lane.ctx is not None:
                    lane.ctx.drop(i)
                self.metrics.on_shed(h.rid, now)
                h._finish(None, "shed")
            release = lane.ctx.release if lane.ctx is not None else None
            for s in range(lane.sched.batch_slots):
                if lane.sched._slots[s] is not None:
                    lane.state = lane.sched.fail_running(
                        lane.state, s,
                        RequestCancelled("server shutdown"),
                        release=release, on_fail=onf)


class StreamingServer:
    """Background-thread front over :class:`ServingLoop`.

    ::

        server = StreamingServer(engine, params, ServerConfig(...))
        with server:                       # starts the serving thread
            h = server.submit(GenerationRequest(prompt, 32, deadline_s=2.0))
            for delta in h.tokens():       # per-token streaming
                emit(delta)
            result = h.result()            # None if the request was shed
        print(server.metrics.summary())
    """

    def __init__(self, engine: SpecEngine, params, cfg: ServerConfig = ServerConfig(),
                 *, poll_idle_s: float = 0.002, tracer=None,
                 metrics: Optional[ServerMetrics] = None, faults=None,
                 restart_backoff_s: float = 0.05, max_restarts: int = 3):
        self.loop = ServingLoop(engine, params, cfg, tracer=tracer,
                                metrics=metrics, faults=faults)
        self.poll_idle_s = poll_idle_s
        self.restart_backoff_s = restart_backoff_s
        self.max_restarts = max_restarts       # consecutive, then abort
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def metrics(self) -> ServerMetrics:
        return self.loop.metrics

    def start(self) -> "StreamingServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="repro-torch-serving-loop", daemon=True)
        self._thread.start()
        return self

    def submit(self, request: GenerationRequest) -> StreamHandle:
        if self._thread is None:
            raise RuntimeError("server not started (use `with server:` "
                               "or server.start())")
        handle = self.loop.submit(request)
        self._wake.set()
        return handle

    def _run(self) -> None:
        """Serving-thread body: poll under a supervisor.  Each crash is
        contained (``ServingLoop.recover``) and the loop restarts with
        capped exponential backoff; ``max_restarts`` *consecutive* crashes
        abort the loop — every in-flight request fails with the terminal
        error, which also re-raises from :meth:`stop`."""
        crashes = 0
        backoff = self.restart_backoff_s
        while not self._stop.is_set():
            try:
                worked = self.loop.poll()
            except Exception as exc:  # noqa: BLE001 — supervisor seam
                crashes += 1
                self.metrics.on_guardrail("lane_restarts")
                if crashes > self.max_restarts:
                    err = LaneCrashed(
                        f"serving loop crashed {crashes} consecutive "
                        f"times; giving up: {type(exc).__name__}: {exc}")
                    err.__cause__ = exc
                    self.loop.abort(err)
                    return
                self.loop.recover(exc)
                self._stop.wait(backoff)
                backoff = min(backoff * 2.0, 5.0)
                continue
            crashes = 0
            backoff = self.restart_backoff_s
            if not worked:
                # idle: sleep until a submit wakes us (bounded, so deadline
                # shedding still fires for queued work)
                self._wake.wait(self.poll_idle_s)
                self._wake.clear()

    def stop(self, *, drain: bool = True, timeout: float = 600.0) -> None:
        """Stop the serving thread (draining first by default).  If the
        supervisor gave up (``loop.dead``), the terminal error re-raises
        here."""
        if self._thread is None:
            if self.loop.dead is not None:
                raise self.loop.dead
            return
        if drain:
            t0 = time.monotonic()
            while self.loop.busy and self.loop.dead is None:
                if time.monotonic() - t0 > timeout:
                    raise RuntimeError("StreamingServer.stop: drain timeout")
                time.sleep(self.poll_idle_s)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        self._thread = None
        if self.loop.dead is not None:
            raise self.loop.dead

    def __enter__(self) -> "StreamingServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.stop(drain=exc_type is None)
        except BaseException:
            if exc_type is None:
                raise
            # an exception is already in flight from the with-body: don't
            # mask it with the teardown's
