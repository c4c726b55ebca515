"""Batched speculative serving engine — port of ``repro/serving/engine.py``.

    engine = SpecEngine(model, SpecConfig(verifier="w8a8"))   # Quasar
    result = engine.generate(params, prompts, max_new_tokens=64)
    results = engine.generate_requests(params, requests)      # scheduled

Two entry points:

* :meth:`SpecEngine.generate` — one homogeneous batch ``(B, P)``, shared
  token budget;
* :meth:`SpecEngine.generate_requests` — a list of
  :class:`~repro_torch.serving.request.GenerationRequest` with
  heterogeneous prompt lengths, budgets, seeds and temperatures, served
  through the continuous-batching
  :class:`~repro_torch.serving.scheduler.Scheduler`: a fixed number of
  slots steps together, and a finished row is refilled from the pending
  queue mid-loop by :meth:`SpecEngine.prefill_into_slot`.  With
  ``SpecConfig(kv_layout="paged")`` the cache is the block pool of
  ``core/paged_cache.py``, driven by :class:`PagedGroup` (admission
  control, block top-up, prefix sharing, preemption and swap).

The verifier owns offline weight preparation: with ``verifier="w8a8"``
the engine quantizes the params (SmoothQuant + INT8) on first use.

Unlike the reference's functional state, the port **updates the engine
state in place**: admission, release, preemption and resume write the
rows of the state's tensors (and the paged pools and block table), and
the decode step writes the KV cache in place.  So admission allocates no
new state tensor, and any code that keeps a row across a step copies it
(the preemption snapshot does).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.config import SpecConfig
from repro_torch.core.paged_cache import (
    SCRATCH_BLOCK,
    BlockPool,
    PrefixIndex,
    clone_block,
    init_paged_cache,
    plan_group,
    request_demand_tokens,
    scatter_prefill_rows,
    swap_in_blocks,
    swap_out_blocks,
)
from repro_torch.core.protocols import get_drafter, get_verifier
from repro_torch.core.spec_engine import init_state, make_decode_step
from repro_torch.serving.faults import NULL_FAULTS, InjectedFault, RequestFault
from repro_torch.serving.metrics import AcceptanceStats
from repro_torch.serving.request import GenerationRequest, RequestResult, pad_prompt
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.trace import NULL_TRACER

_MAX_TEMP_STEPS = 8        # bound on the per-temperature decode-step cache
DEFAULT_BATCH_SLOTS = 8    # decode rows per scheduler loop (memory bound)


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


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_zip(fn, full, part) -> None:
    """Call ``fn(full_tensor, part_tensor)`` over two trees of one shape."""
    if isinstance(full, dict):
        for k in full:
            _tree_zip(fn, full[k], part[k])
    elif isinstance(full, (list, tuple)):
        for a, b in zip(full, part):
            _tree_zip(fn, a, b)
    else:
        fn(full, part)


def _tensors(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _write_table_row(bt: torch.Tensor, row: int, ids: Sequence[int]) -> None:
    """Block-table row ``row`` := ``ids`` followed by scratch, in place."""
    vals = np.full((bt.shape[1],), SCRATCH_BLOCK, np.int32)
    vals[:len(ids)] = ids
    bt[row] = torch.from_numpy(vals).to(bt.device)


class SpecEngine:
    """Drafter × Verifier serving engine."""

    def __init__(self, model, scfg: SpecConfig = SpecConfig(), *,
                 drafter=None, verifier=None):
        if scfg.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {scfg.kv_layout!r}; "
                             "expected 'contiguous' or 'paged'")
        self.model = model
        self.scfg = scfg
        self.drafter = get_drafter(drafter if drafter is not None else scfg.drafter, scfg)
        self.verifier = get_verifier(
            verifier if verifier is not None else scfg.verifier, scfg)
        self._step = make_decode_step(model, self.drafter, self.verifier, scfg)
        self._steps_by_temp = {}                   # temperature overrides
        self._prepared = None                      # (params ref, prepared)
        # per-group sizing of the last generate_requests call
        self.group_stats: List[dict] = []
        # per drafter×verifier acceptance / step-time telemetry, across
        # generate and generate_requests calls
        self.telemetry = AcceptanceStats()

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

    def _step_for_temperature(self, t: float):
        """(decode step, drafter) with temperature ``t`` built in."""
        if t == self.scfg.temperature:
            return self._step, self.drafter
        if t not in self._steps_by_temp:
            if len(self._steps_by_temp) >= _MAX_TEMP_STEPS:
                self._steps_by_temp.pop(next(iter(self._steps_by_temp)))
            scfg_t = dataclasses.replace(self.scfg, temperature=t)
            drafter = self.drafter.with_temperature(t)
            step = make_decode_step(self.model, drafter, self.verifier, scfg_t)
            self._steps_by_temp[t] = (step, drafter)
        return self._steps_by_temp[t]

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
        lengths per step, which also feeds the acceptance telemetry).
        Returns (state, wall seconds)."""
        dev = self.model.device
        tkey = f"{self.drafter.name}:{self.verifier.name}"
        targets = state["target"].cpu().numpy()
        prev = np.minimum(state["length"].cpu().numpy(), targets)
        _sync(dev)
        t0 = time.perf_counter()
        steps = 0
        while True:
            t_s = time.perf_counter()
            state = self._step(params, state)
            lengths = state["length"].cpu().numpy()
            steps += 1
            cur = np.minimum(lengths, targets)
            self.telemetry.on_decode_step(tkey, (cur - prev)[prev < targets].tolist(),
                                          time.perf_counter() - t_s)
            prev = cur
            if bool((lengths >= targets).all()) or steps > max_steps:
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

    # ------------------------------------------------------------------
    # Continuous batching
    # ------------------------------------------------------------------
    def prefill_into_slot(self, params, state: dict, row: int, request: GenerationRequest,
                          *, pmax: Optional[int] = None, drafter=None, draft_params=None,
                          pool: Optional[BlockPool] = None, rid: Optional[int] = None,
                          shared_blocks: int = 0, shared_rows: int = 0) -> dict:
        """Admit ``request`` into slot ``row`` of a live decode state, **in
        place** (returns the same dict).

        Resets every per-row slice the decode step reads: token buffer,
        committed length, target, the row's generator
        (``prng.request_generator(request.seed)``), acceptance stats and the
        ``bad`` flag, the KV cache row (zeroed, then prefilled, so nothing
        leaks from the slot's previous occupant) and the drafter-state row
        (``Drafter.prefill_row``).  No state tensor is reallocated.

        With a **paged** cache (``"bt"`` in ``state["cache"]``) the cache
        reset becomes: allocate the prompt's blocks from ``pool`` under
        ``rid``'s reservation, point the slot's block-table row at them
        (scratch past them), and scatter a single-row contiguous prefill
        into them (``core/paged_cache.scatter_prefill_rows``).  With a
        prefix-cache hit (``shared_blocks`` leading blocks of ``rid``'s
        table already hold ``shared_rows`` prompt rows) the shared rows are
        gathered into the row cache and only the cold tail is prefilled
        (``Model.prefill_chunk``); int8 KV recomputes the whole prompt, as
        in the reference.  ``pmax`` fixes the padded prompt length (the
        group's maximum); ``params`` must already be prepared.
        """
        drafter = drafter if drafter is not None else self.drafter
        dev = self.model.device
        P = request.prompt.size
        buf = state["tokens"].shape[1]
        pmax = P if pmax is None else pmax
        if not P <= pmax <= buf:
            raise ValueError(f"pmax {pmax} outside [{P}, {buf}]")
        prompt = torch.from_numpy(pad_prompt(request.prompt, pmax)).to(dev)[None]  # (1, pmax)

        state["tokens"][row] = 0
        state["tokens"][row, :pmax] = prompt[0]
        state["length"][row] = P
        state["target"][row] = P + request.max_new_tokens
        state["generators"][row] = prng.request_generator(request.seed, dev)
        for name in ("commits", "row_steps", "bad"):
            state["stats"][name][row] = 0

        # KV cache row: zeroed + single-row prefill.  The padded prefill
        # writes junk K/V at positions [P-1, pmax-1), but verify windows
        # rewrite every position before the causal frontier reaches it.
        paged = "bt" in state["cache"]
        if paged:
            if pool is None or rid is None:
                raise ValueError("paged admission needs pool= and rid=")
            row_cache = self.model.init_cache(1, buf)
        else:          # the state's own row, as views that write through
            row_cache = {"layers": [{name: t[row:row + 1] for name, t in layer.items()}
                                    for layer in state["cache"]["layers"]]}
            for t in _tensors(row_cache):
                t.zero_()
        if paged and shared_rows > 0 and self.model.cfg.kv_cache_dtype != "int8":
            c = int(shared_rows)
            idx = torch.as_tensor(pool.owned(rid)[:int(shared_blocks)], device=dev)
            for pool_l, row_l in zip(state["cache"]["layers"], row_cache["layers"]):
                for name, buf_l in pool_l.items():
                    warm = buf_l[idx].reshape((-1,) + tuple(buf_l.shape[2:]))[:c]
                    row_l[name][0, :c] = warm.to(row_l[name].dtype)
            if P - 1 > c:
                self.model.prefill_chunk(params, row_cache, prompt[:, c:P - 1], c)
        else:
            self.model.prefill(params, row_cache, prompt[:, :-1])
        if paged:
            n_shared = int(shared_blocks)
            fork = n_shared > 0 and int(shared_rows) % pool.block_size != 0
            if fork:
                # the last shared block is a partially-matched boundary:
                # fork it copy-on-write so our tail rows never touch the
                # donor's copy; the scatter below rewrites the fork block
                # wholesale (gathered shared rows + computed tail + zeros)
                old = pool.owned(rid)[n_shared - 1]
                if pool.cow(rid, old) == old and pool.prefix is not None:
                    # sole owner (a resurrected cached block): written in
                    # place, so drop the donor's boundary entry, which may
                    # claim rows beyond what we matched
                    pool.prefix.evict_block(old)
            pool.alloc(rid, pool.blocks_for(P) - n_shared)
            ids = pool.owned(rid)
            w0 = n_shared - (1 if fork else 0)   # first block we must write
            _write_table_row(state["cache"]["bt"], row, ids)
            for pool_l, row_l in zip(state["cache"]["layers"], row_cache["layers"]):
                scatter_prefill_rows(pool_l, ids[w0:], row_l, pool.block_size,
                                     first_block=w0)
        # the drafter gets the UNPADDED prompt (see Drafter.prefill_row)
        state["drafter_state"] = drafter.prefill_row(
            self.model, params, state["drafter_state"], row,
            torch.tensor(request.prompt, device=dev)[None], buf, draft_params=draft_params)
        return state

    def _check_paged_supported(self):
        """Paged KV needs attention-family, full-causal, contiguous-slot
        caches (as in the reference; the port's models are dense decoders,
        so only the sliding-window check can fire)."""
        cfg = self.model.cfg
        if cfg.arch_type in ("ssm", "hybrid") or cfg.cross_attn_every or cfg.encoder_layers:
            raise ValueError(f"kv_layout='paged' supports dense/moe self-attention "
                             f"stacks only, not {cfg.arch_type!r}")
        if cfg.sliding_window:
            raise ValueError("kv_layout='paged' does not compose with sliding-window "
                             "(ring) caches — the ring already bounds the footprint")

    def _append_paged_blocks(self, state: dict, pool: BlockPool, live: dict, gamma: int,
                             lengths: np.ndarray) -> dict:
        """Append-on-commit, in place: before each decode step, top every
        live row's blocks up to its next verify window's reach
        (``length + gamma + 1`` rows, capped at the request's demand).
        Draws against the admission-time reservation, so it cannot fail
        absent fault injection.  A per-slot failure is collected; every
        other row's top-up still lands, then one
        :class:`~repro_torch.serving.faults.RequestFault` names the failing
        slots and carries the (current, pool-consistent) state."""
        bt = state["cache"]["bt"]
        failures = []
        for slot, (rid, demand_tokens) in live.items():
            need = pool.blocks_for(min(int(lengths[slot]) + gamma + 1, demand_tokens))
            have = len(pool.owned(rid))
            if need > have:
                try:
                    ids = pool.alloc(rid, need - have)
                except Exception as exc:  # noqa: BLE001 — containment seam
                    failures.append((slot, exc))
                    continue
                bt[slot, have:need] = torch.as_tensor(ids, dtype=torch.int32).to(bt.device)
        if failures:
            raise RequestFault(
                f"block append failed for slots {[s for s, _ in failures]}: "
                f"{failures[0][1]}", slots=[s for s, _ in failures], state=state,
                cause=failures[0][1])
        return state

    def paged_group(self, *, num_blocks: int, block_size: int, gamma: int, tracer=None,
                    trace_tid: int = 0, faults=None) -> "PagedGroup":
        """The per-group paged-serving context (allocator + prefix index +
        swap pool) honouring ``SpecConfig.kv_prefix_sharing``; ``faults``
        installs a :class:`~repro_torch.serving.faults.FaultPlan` on the
        group's allocation and swap-in seams."""
        return PagedGroup(self, num_blocks=num_blocks, block_size=block_size, gamma=gamma,
                          sharing=self.scfg.kv_prefix_sharing, tracer=tracer,
                          trace_tid=trace_tid, faults=faults)

    def serving_group(self, params, batch: Sequence[GenerationRequest], *,
                      temperature: Optional[float] = None,
                      batch_slots: Optional[int] = None, draft_params=None, tracer=None,
                      trace_tid: int = 0) -> "ServingGroup":
        """Set up one temperature group's serving loop over ``batch``: the
        cache (contiguous, or the paged pool sized by ``plan_group``), the
        all-idle state and the scheduler hooks.  ``generate_requests`` runs
        it with ``Scheduler.run``; an open-loop caller ticks it, submitting
        ``batch[i]`` as scheduler index ``i``.  ``params`` must be
        prepared."""
        t = self.scfg.temperature if temperature is None else float(temperature)
        step, drafter = self._step_for_temperature(t)
        dev = self.model.device
        pmax = max(r.prompt.size for r in batch)
        buf = max(r.prompt.size + r.max_new_tokens for r in batch) + drafter.gamma + 2
        paged = self.scfg.kv_layout == "paged"
        ctx = cache = None
        if paged:
            self._check_paged_supported()
            plan = plan_group([r.prompt.size for r in batch],
                              [r.max_new_tokens for r in batch], drafter.gamma, buf,
                              block_size=self.scfg.kv_block_size,
                              pool_blocks=self.scfg.kv_pool_blocks, batch_slots=batch_slots,
                              default_slots=DEFAULT_BATCH_SLOTS)
            slots = plan.slots
            ctx = self.paged_group(num_blocks=plan.num_blocks, block_size=plan.block_size,
                                   gamma=drafter.gamma, tracer=tracer, trace_tid=trace_tid)
            for j, r in enumerate(batch):
                ctx.register(j, r)
            cache = init_paged_cache(self.model.cfg, slots, plan.max_blocks, plan.num_blocks,
                                     plan.block_size, device=dev)
        else:
            slots = min(DEFAULT_BATCH_SLOTS if batch_slots is None else batch_slots,
                        len(batch))
        # all slots idle (length == target == 0); the scheduler admits
        state = init_state(
            self.model, slots, buf, prng.row_generators([0] * slots, dev),
            drafter_state=drafter.alloc_state(self.model, params, slots, buf,
                                              draft_params=draft_params),
            target=torch.zeros((slots,), dtype=torch.int32), cache=cache)
        stats = {"temperature": t, "slots": slots, "buf": buf,
                 "kv_layout": "paged" if paged else "contiguous",
                 "cache_bytes": sum(x.nbytes for x in _tensors(state["cache"]))}
        if paged:
            stats.update(pool_blocks=plan.num_blocks, block_size=plan.block_size)
            hooks = dict(
                admit=lambda st, slot, j: ctx.admit(st, slot, j, params=params, pmax=pmax,
                                                    drafter=drafter,
                                                    draft_params=draft_params),
                step=lambda st: step(params, ctx.prepare_step(st)),
                can_admit=ctx.can_admit, release=ctx.release,
                preempt=ctx.preempt if self.scfg.kv_preempt else None)
        else:
            hooks = dict(
                admit=lambda st, slot, j: self.prefill_into_slot(
                    params, st, slot, batch[j], pmax=pmax, drafter=drafter,
                    draft_params=draft_params),
                step=lambda st: step(params, st))
        return ServingGroup(state, hooks, ctx, f"{drafter.name}:{self.verifier.name}", stats)

    @torch.inference_mode()
    def generate_requests(self, params, requests: Sequence[GenerationRequest], *,
                          batch_slots: Optional[int] = None, draft_params=None,
                          admission: str = "fifo", on_tokens=None,
                          tracer=None) -> List[RequestResult]:
        """Serve requests with heterogeneous prompt lengths, budgets, seeds
        and temperatures; returns results in request order.

        Requests flow through the continuous-batching scheduler:
        ``batch_slots`` rows (default ``min(len(group), 8)``) step
        together, and finished rows are refilled from the pending queue
        mid-loop.  Each request's tokens equal serving it solo (per-row
        generators and a full per-row reset at admission).  Temperature is
        a constant of the decode step, so requests are grouped by it and
        the groups served one after the other (:meth:`serving_group`).

        With ``SpecConfig(kv_layout="paged")`` the cache is the block pool:
        admission reserves each request's worst-case block demand (requests
        wait when the pool is full — head-of-line, priority order kept),
        blocks are appended as rows commit and released at harvest,
        prompts share cached prefix blocks (``kv_prefix_sharing``), and —
        unless ``batch_slots`` is forced — the slot count is sized from
        pool occupancy.  Tokens equal the contiguous layout's.
        ``admission="edf"`` orders admissions earliest-deadline-first
        within a priority class; ``on_tokens(request_index, tokens)``
        streams each request's newly committed tokens after every step.
        """
        if not requests:
            return []
        t_arrival = time.perf_counter()
        self.group_stats = []
        params = self._prepare_cached(params)
        results: List[Optional[RequestResult]] = [None] * len(requests)
        groups = {}
        for i, r in enumerate(requests):
            t = self.scfg.temperature if r.temperature is None else float(r.temperature)
            groups.setdefault(t, []).append(i)
        tr = tracer if tracer is not None else NULL_TRACER
        for gi, (t, idxs) in enumerate(groups.items()):
            tr.thread_name(gi, f"group{gi} T={t:g}")
            batch = [requests[i] for i in idxs]
            group = self.serving_group(params, batch, temperature=t, batch_slots=batch_slots,
                                       draft_params=draft_params, tracer=tracer,
                                       trace_tid=gi)
            self.group_stats.append(group.stats)
            group_on_tokens = None
            if on_tokens is not None:
                def group_on_tokens(j, toks, _idxs=idxs):
                    on_tokens(_idxs[j], toks)     # group -> request index

            def group_stats_cb(accepted, step_s, n_tokens, _k=group.key):
                self.telemetry.on_decode_step(_k, accepted, step_s)

            sched = Scheduler(batch, group.stats["slots"], policy=admission, tracer=tracer,
                              trace_tid=gi, trace_ids=idxs, on_step_stats=group_stats_cb)
            _, group_results = sched.run(group.state, t0=t_arrival, on_tokens=group_on_tokens,
                                         **group.hooks)
            group.stats["steps"] = sched.steps
            if group.ctx is not None:
                group.stats.update(
                    peak_blocks=group.ctx.pool.peak_allocated,
                    shared_blocks=group.ctx.shared_blocks, shared_rows=group.ctx.shared_rows,
                    cow_forks=group.ctx.cow_forks, preemptions=sched.preemptions)
            for j, i in enumerate(idxs):
                results[i] = group_results[j]
        return results


@dataclass
class ServingGroup:
    """One temperature group's serving loop (``SpecEngine.serving_group``):
    ``Scheduler.run(state, **hooks)`` or ``Scheduler.tick(state, **hooks)``
    drives it."""

    state: dict
    hooks: dict                        # admit, step [, can_admit, release, preempt]
    ctx: Optional["PagedGroup"]        # the paged layout's allocator context
    key: str                           # "drafter:verifier", the telemetry key
    stats: dict                        # sizing; generate_requests adds run stats


class PagedGroup:
    """Paged-serving context for one scheduler group: the refcounting
    :class:`~repro_torch.core.paged_cache.BlockPool`, the prefix-cache
    :class:`~repro_torch.core.paged_cache.PrefixIndex`, and the host swap
    pool for preempted requests.

    Owns the scheduler hooks around the decode step; each writes the
    state in place:

    * :meth:`can_admit` / :meth:`admit` — prefix-aware admission: probe
      the index, reserve only the *fresh-block* demand (minus shared full
      blocks, plus a fork for a partially-matched boundary), share the
      cached chain, prefill the cold tail, and register this prompt's
      blocks for later arrivals.  A swapped-out request resumes instead.
    * :meth:`preempt` — snapshot the victim's committed cache rows and
      per-row decode state to host memory (copies), free its blocks now.
    * :meth:`prepare_step` — block top-up plus a defensive copy-on-write
      sweep: a still-shared block inside a live row's next verify window
      is forked before the step can write it.
    * :meth:`release` / :meth:`drop` — exactly-once block return.

    The table row of a slot always equals its request's block list
    (``pool.owned(rid)``) followed by scratch, so the host never reads the
    block table back from the card.
    """

    def __init__(self, engine: SpecEngine, *, num_blocks: int, block_size: int,
                 gamma: int, sharing: bool = True, tracer=None, trace_tid: int = 0,
                 faults=None):
        self.engine = engine
        self.gamma = int(gamma)
        self.index = PrefixIndex(block_size) if sharing else None
        self.pool = BlockPool(num_blocks, block_size, prefix=self.index)
        self.faults = faults if faults is not None else NULL_FAULTS
        if self.faults.enabled:
            def _alloc_fault(n, _f=self.faults):
                if _f.fire("alloc", blocks=int(n)):
                    raise InjectedFault(f"injected BlockPool alloc failure ({n} blocks)")
            self.pool.fault_hook = _alloc_fault
        self.live: dict = {}       # slot -> (rid, demand_tokens)
        self.swap: dict = {}       # rid  -> host snapshot
        self._reqs: dict = {}      # rid  -> request
        self._tr = tracer if tracer is not None else NULL_TRACER
        self.trace_tid = int(trace_tid)
        self.shared_blocks = 0     # prefix-cache block hits
        self.shared_rows = 0       # prompt rows served from cache
        self.swaps = 0             # preemptions executed
        self.cow_forks = 0         # boundary forks (admission + sweep)
        self.prefix_hits = 0       # admissions that shared >= 1 block
        self.prefix_misses = 0     # sharing-eligible admissions, cold
        self.shared_tokens = 0     # prompt rows gathered from the cache
        self.cold_prefill_tokens = 0
        self.resurrections = 0     # cached-free blocks shared back in
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.swapped_out_blocks = 0
        self.swapped_in_blocks = 0

    # -- registration --------------------------------------------------
    def register(self, rid: int, request: GenerationRequest) -> None:
        """Associate ``rid`` with its request before any hook runs."""
        self._reqs[rid] = request

    def demand_tokens(self, rid: int) -> int:
        r = self._reqs[rid]
        return request_demand_tokens(r.prompt.size, r.max_new_tokens, self.gamma)

    def demand_blocks(self, rid: int) -> int:
        return self.pool.blocks_for(self.demand_tokens(rid))

    def _probe(self, rid: int):
        """(shared block ids, prompt rows they cover, cached-free count);
        empty with sharing off or on a cold index."""
        if self.index is None:
            return [], 0, 0
        ids, rows = self.index.lookup(self._reqs[rid].prompt)
        return ids, rows, sum(1 for b in ids if self.pool.ref(b) == 0)

    def _admission_need(self, rid: int):
        """(fresh-block reservation, probe) for admitting ``rid`` now.
        When the shared plan does not fit but the plain worst case does,
        the request admits unshared (a tight pool serializes instead of
        deadlocking on sharing arithmetic)."""
        d = self.demand_blocks(rid)
        ids, rows, n_res = self._probe(rid)
        if ids:
            fork = 1 if rows % self.pool.block_size != 0 else 0
            need = d - len(ids) + fork
            if self.pool.can_reserve(need + n_res):
                return need, (ids, rows, n_res)
        return d, ([], 0, 0)

    # -- scheduler hooks -----------------------------------------------
    def can_admit(self, rid: int) -> bool:
        if rid in self.swap:
            return self.pool.can_reserve(self.demand_blocks(rid))
        # resurrecting a cached-free block consumes one slack unit even
        # though it is not a fresh draw — count it in the gate
        need, (_, _, n_res) = self._admission_need(rid)
        return self.pool.can_reserve(need + n_res)

    def admit(self, state: dict, slot: int, rid: int, *, params, pmax: int, drafter,
              draft_params=None) -> dict:
        if rid in self.swap:
            return self._resume(state, slot, rid)
        r = self._reqs[rid]
        need, (ids, rows, n_res) = self._admission_need(rid)
        P = r.prompt.size
        bs = self.pool.block_size
        # +1 COW headroom lets us *donate* our partially-filled boundary
        # block to the index; skipped — not failed — when the pool is tight
        head = 1 if (self.index is not None and (P - 1) % bs != 0) else 0
        donate = bool(head) and self.pool.can_reserve(need + n_res + head)
        self.pool.reserve(rid, need + (head if donate else 0))
        if ids:
            self.pool.share(rid, ids)
            self.shared_blocks += len(ids)
            self.shared_rows += rows
        if self.index is not None:
            if ids:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1
        self.shared_tokens += rows
        self.cold_prefill_tokens += max(P - 1 - rows, 0)
        self.resurrections += n_res
        self.live[slot] = (rid, self.demand_tokens(rid))
        if ids and rows % bs != 0:
            self.cow_forks += 1          # prefill_into_slot forks below
        with self._tr.span("prefill", tid=self.trace_tid, rid=rid, shared_rows=rows,
                           cold_rows=max(P - 1 - rows, 0)):
            state = self.engine.prefill_into_slot(
                params, state, slot, r, pmax=pmax, drafter=drafter,
                draft_params=draft_params, pool=self.pool, rid=rid,
                shared_blocks=len(ids), shared_rows=rows)
        if self.index is not None:
            self.index.register(r.prompt, self.pool.owned(rid), include_boundary=donate)
        return state

    def release(self, state: dict, slot: int, rid: int) -> dict:
        """Harvest hook: return blocks (exactly once) and point the row at
        scratch — an idle row keeps stepping, and its discarded window
        writes must not land in blocks the next admission may get."""
        self.pool.release(rid)
        self.live.pop(slot, None)
        state["cache"]["bt"][slot] = SCRATCH_BLOCK
        return state

    def drop(self, rid: int) -> None:
        """Forget a request that will never resume (shed while swapped)."""
        self.swap.pop(rid, None)
        self.pool.release(rid)

    # -- preemption / swap ---------------------------------------------
    def preempt(self, state: dict, slot: int, rid: int) -> dict:
        """Evict ``slot``'s occupant to the host swap pool.

        Copies the committed cache rows ``[0, length - 1)`` (everything a
        later verify window reads) and every per-row decode register —
        tokens, length, target, the generator's state, stats, the drafter
        row — to host memory, then frees the blocks and reservation.  The
        row is left idle (``length == target == 0``, table at scratch)."""
        self.live.pop(slot, None)
        L = int(state["length"][slot])
        n_save = self.pool.blocks_for(max(L - 1, 0))
        ids = self.pool.owned(rid)[:n_save]
        host = lambda x: x[slot].to("cpu", copy=True)  # noqa: E731
        with self._tr.span("swap_out", tid=self.trace_tid, rid=rid, blocks=n_save):
            snap = {
                "n_blocks": n_save,
                "blocks": swap_out_blocks(state["cache"]["layers"], ids),
                "tokens": host(state["tokens"]),
                "length": L,
                "target": int(state["target"][slot]),
                "generator": state["generators"][slot].get_state(),
                "commits": int(state["stats"]["commits"][slot]),
                "row_steps": int(state["stats"]["row_steps"][slot]),
                "drafter": _tree_map(host, state["drafter_state"]),
            }
        self.pool.swap_out(rid)
        self.swap[rid] = snap
        self.swaps += 1
        self.swap_out_bytes += sum(x.nbytes for x in _tensors(snap["blocks"]))
        self.swapped_out_blocks += n_save
        state["length"][slot] = 0
        state["target"][slot] = 0
        state["cache"]["bt"][slot] = SCRATCH_BLOCK
        return state

    def _resume(self, state: dict, slot: int, rid: int) -> dict:
        """Re-admit a swapped request: fresh blocks, exact copy-back."""
        with self._tr.span("swap_in", tid=self.trace_tid, rid=rid):
            snap = self.swap.pop(rid)
            blocks = snap["blocks"]
            if self.faults.fire("swap_in", rid=rid):
                # corrupt the snapshot's float KV payload (NaN): the resumed
                # row decodes against poisoned state and the verify-path
                # tripwire flags it; int8 KV codes are left as they are
                blocks = _tree_map(lambda x: torch.full_like(x, float("nan"))
                                   if x.is_floating_point() else x, blocks)
            self.pool.reserve(rid, self.demand_blocks(rid))
            ids = self.pool.alloc(rid, snap["n_blocks"])
            self.swap_in_bytes += sum(x.nbytes for x in _tensors(blocks))
            self.swapped_in_blocks += len(ids)
            dev = state["tokens"].device
            state["tokens"][slot] = snap["tokens"].to(dev)
            state["length"][slot] = snap["length"]
            state["target"][slot] = snap["target"]
            gen = torch.Generator(device=dev)
            gen.set_state(snap["generator"])
            state["generators"][slot] = gen
            state["stats"]["commits"][slot] = snap["commits"]
            state["stats"]["row_steps"][slot] = snap["row_steps"]
            state["stats"]["bad"][slot] = False

            def put(full, one):
                full[slot] = one.to(full.device, full.dtype)

            _tree_zip(put, state["drafter_state"], snap["drafter"])
            _write_table_row(state["cache"]["bt"], slot, ids)
            swap_in_blocks(state["cache"]["layers"], ids, blocks)
            self.live[slot] = (rid, self.demand_tokens(rid))
        return state

    # -- per-step maintenance ------------------------------------------
    def prepare_step(self, state: dict) -> dict:
        """Run before every decode step: block top-up + COW sweep, in
        place, from one host read of the lengths."""
        if not self.live:
            return state
        lengths = state["length"].cpu().numpy()
        with self._tr.span("append_blocks", tid=self.trace_tid):
            self.engine._append_paged_blocks(state, self.pool, self.live, self.gamma,
                                             lengths)
        if self.index is None:
            return state
        # defensive copy-on-write: fork any still-shared block the next
        # verify window would write (rows [L-1, L+gamma])
        bt = state["cache"]["bt"]
        bs = self.pool.block_size
        for slot, (rid, _demand) in self.live.items():
            owned = self.pool.owned(rid)             # == the slot's table row
            L = int(lengths[slot])
            lo = max(L - 1, 0) // bs
            hi = min((L + self.gamma) // bs, bt.shape[1] - 1)
            for k in range(lo, min(hi + 1, len(owned))):
                bid = owned[k]
                if self.pool.ref(bid) <= 1:
                    continue
                new = self.pool.cow(rid, bid)
                clone_block(state["cache"]["layers"], bid, new)
                bt[slot, k] = new
                self.cow_forks += 1
        return state

    # -- observability -------------------------------------------------
    def snapshot(self) -> dict:
        """Monotone counters plus this group's point-in-time pool gauges
        (the reference's ``kv_cache`` metrics schema)."""
        return {
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "shared_blocks": self.shared_blocks,
            "shared_tokens": self.shared_tokens,
            "cold_prefill_tokens": self.cold_prefill_tokens,
            "cow_forks": self.cow_forks,
            "resurrections": self.resurrections,
            "cached_evicted": self.pool.counters["cached_evicted"],
            "swap_out_blocks": self.swapped_out_blocks,
            "swap_in_blocks": self.swapped_in_blocks,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
            "preemptions": self.swaps,
            "pool": {
                "capacity": self.pool.capacity,
                "free": self.pool.free_blocks,
                "cached": self.pool.cached_blocks,
                "unique_allocated": self.pool.unique_allocated,
                "peak_allocated": self.pool.peak_allocated,
            },
        }

    # -- invariants ----------------------------------------------------
    def check_invariants(self) -> None:
        self.pool.check_invariants()
        for slot, (rid, _d) in self.live.items():
            assert rid not in self.swap, f"request {rid} both live and swapped"
