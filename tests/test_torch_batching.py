"""The port's continuous batching against the JAX package, and the port's
own serving-loop losslessness.  The setup at the top (request mix, both
models on the same bridged f32 weights, scheduled runs on both sides) is
shared with ``test_torch_paged.py``.

* The scheduler (``serving/scheduler.py``, copied with one host read per
  tick) drives a model-free synthetic decode loop exactly as the
  reference's does: same admissions, harvests, events and results.
* The copied host modules (request packing, histograms, the tracer, fault
  plans) behave as the reference's on the same calls.
* Scheduled ``generate_requests`` over the contiguous cache gives the
  reference's greedy (T = 0) tokens per request on ``smollm-135m``
  ``.reduced()`` (f32, bridged weights) for each drafter and verifier.
* Inside the port, scheduled ≡ solo at T = 0 and T > 0 (per-row
  generators), streamed deltas concatenate to the results, and admission
  allocates no new state tensor — the eager counterpart of the
  reference's ``step_traces == 1`` (no retrace on admission) invariant,
  which has none: the port has no compile step, so the test checks that
  the state keeps its tensors (storage pointers) across admissions.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.config import SpecConfig as JSpecConfig
from repro.models import Model as JModel
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.histogram import Histogram as JHistogram
from repro.serving.request import GenerationRequest as JRequest
from repro.serving.request import pack_prompts as jpack
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.trace import Tracer as JTracer
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.histogram import Histogram
from repro_torch.serving.request import GenerationRequest, pack_prompts
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.trace import Tracer

SRC = Path(__file__).resolve().parent.parent / "src"

SPEC = ((5, 6, 11), (4, 9, 22), (3, 7, 33), (2, 5, 44), (4, 3, 55))


def request_mix(cls=GenerationRequest, V=256, spec=SPEC, temperature=None):
    """Heterogeneous mix: (pattern reps, budget, seed) triples over one
    repeated pattern, so prompt lookup finds drafts."""
    rng = np.random.default_rng(3)
    pat = rng.integers(0, V, 6)
    return [cls(np.tile(pat, k), max_new_tokens=n, seed=s, temperature=temperature)
            for k, n, s in spec]


JSCFG = dict(temperature=0.0, gamma=3, pruned_retention=0.5, tree_branches=(2, 1, 1))


@functools.lru_cache(maxsize=None)
def jax_setup():
    jcfg = jget_config("smollm-135m").reduced()
    return JModel(jcfg), JModel(jcfg).init_params(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_setup():
    cfg = get_config("smollm-135m").reduced()
    _, jparams = jax_setup()
    return Model(cfg, device="cpu"), from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                                     device="cpu")


def jax_scheduled_tokens(drafter, verifier, layout, block_size=8, batch_slots=2):
    """The reference's per-request T = 0 tokens (numpy) for ``_requests``."""
    jmodel, jparams = jax_setup()
    scfg = JSpecConfig(kv_layout=layout, kv_block_size=block_size, **JSCFG)
    out = JSpecEngine(jmodel, scfg, drafter=drafter, verifier=verifier).generate_requests(
        jparams, request_mix(JRequest), batch_slots=batch_slots)
    return [r.tokens for r in out]


def port_scheduled(drafter, verifier, layout, block_size=8, batch_slots=2, reqs=None,
                   **spec):
    model, params = port_setup()
    scfg = SpecConfig(**{**JSCFG, **spec}, kv_layout=layout, kv_block_size=block_size)
    eng = SpecEngine(model, scfg, drafter=drafter, verifier=verifier)
    return eng.generate_requests(params, reqs if reqs is not None else request_mix(),
                                 batch_slots=batch_slots), eng


# ---------------------------------------------------------------------------
# Scheduler: model-free synthetic loop, port vs reference
# ---------------------------------------------------------------------------

def _fake_loop(sched_cls, request_cls, xp, batch_slots, accept_seed, priorities):
    """Drive a scheduler with a synthetic decode step committing 1..3
    tokens per active row per step; the state is numpy (``xp`` np) for
    the reference and torch tensors for the port."""
    budgets = (6, 3, 9, 4, 7, 2, 5)
    reqs = [request_cls(np.arange(2 + i % 4) % 7, max_new_tokens=b, seed=i,
                        priority=priorities[i])
            for i, b in enumerate(budgets)]
    buf = max(r.prompt.size + r.max_new_tokens for r in reqs) + 4
    z = (lambda *shape: np.zeros(shape, np.int32)) if xp is np else \
        (lambda *shape: torch.zeros(shape, dtype=torch.int32))
    state = {"tokens": z(batch_slots, buf), "length": z(batch_slots),
             "target": z(batch_slots),
             "stats": {"commits": z(batch_slots), "row_steps": z(batch_slots)}}
    if xp is not np:
        state["stats"]["bad"] = torch.zeros(batch_slots, dtype=torch.bool)
    rng = np.random.default_rng(accept_seed)

    def admit(st, slot, i):
        r = reqs[i]
        st["tokens"][slot] = 0
        st["tokens"][slot, :r.prompt.size] = (r.prompt if xp is np
                                              else torch.from_numpy(r.prompt))
        st["length"][slot] = r.prompt.size
        st["target"][slot] = r.prompt.size + r.max_new_tokens
        st["stats"]["commits"][slot] = 0
        st["stats"]["row_steps"][slot] = 0
        return st

    def step(st):
        for s in range(batch_slots):
            if int(st["length"][s]) < int(st["target"][s]):
                n = min(int(rng.integers(1, 4)), int(st["target"][s] - st["length"][s]))
                pos = int(st["length"][s])
                st["tokens"][s, pos:pos + n] = 1 + (s % 5)
                st["length"][s] += n
                st["stats"]["commits"][s] += n
                st["stats"]["row_steps"][s] += 1
        return st

    sched = sched_cls(reqs, batch_slots)
    streamed = {}
    _, results = sched.run(state, admit=admit, step=step,
                           on_tokens=lambda i, t: streamed.setdefault(i, []).append(t))
    return sched, results, streamed


@pytest.mark.parametrize("batch_slots,accept_seed,priorities", [
    (1, 0, (0,) * 7), (2, 1, (0,) * 7), (3, 2, (2, 0, 1, 0, 2, 1, 0)), (8, 3, (0,) * 7)])
def test_scheduler_matches_jax_on_synthetic_loop(batch_slots, accept_seed, priorities):
    """Same admissions, harvests, per-request results and streamed deltas
    as the reference's scheduler; conservation holds."""
    js, jres, jstream = _fake_loop(JScheduler, JRequest, np, batch_slots, accept_seed,
                                   priorities)
    ps, pres, pstream = _fake_loop(Scheduler, GenerationRequest, torch, batch_slots,
                                   accept_seed, priorities)
    assert ps.steps == js.steps
    assert [(e.request_index, e.slot, e.admit_step, e.harvest_step) for e in ps.events] == \
        [(e.request_index, e.slot, e.admit_step, e.harvest_step) for e in js.events]
    for p, j in zip(pres, jres):
        np.testing.assert_array_equal(p.tokens, j.tokens)
        assert (p.accept_len, p.steps, p.prompt_len, p.bad) == \
            (j.accept_len, j.steps, j.prompt_len, False)
        assert p.new_tokens == p.request.max_new_tokens
    for i, deltas in pstream.items():
        np.testing.assert_array_equal(np.concatenate(deltas), pres[i].tokens)
        assert [d.tolist() for d in deltas] == [d.tolist() for d in jstream[i]]
    ps.check_conservation()


def test_scheduler_fails_an_unservable_request_and_rejects_bad_slots():
    with pytest.raises(ValueError):
        Scheduler([], 0)
    with pytest.raises(ValueError, match="policy"):
        Scheduler([], 1, policy="lifo")
    reqs = [GenerationRequest(np.arange(3), 2, seed=0)]
    state = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "length": torch.zeros(1, dtype=torch.int32),
             "target": torch.zeros(1, dtype=torch.int32),
             "stats": {n: torch.zeros(1, dtype=torch.int32) for n in ("commits", "row_steps")}}
    state["stats"]["bad"] = torch.zeros(1, dtype=torch.bool)
    sched = Scheduler(reqs, 1)
    _, results = sched.run(state, admit=lambda st, s, i: st, step=lambda st: st,
                           can_admit=lambda i: False)
    assert results == [None] and 0 in sched.failed
    sched.check_conservation()


# ---------------------------------------------------------------------------
# Copied host modules behave as the reference's
# ---------------------------------------------------------------------------

def test_copied_host_modules_match_jax():
    reqs = request_mix()
    jp, jl = jpack(request_mix(JRequest))
    pp, pl = pack_prompts(reqs)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pl, jl)
    rng = np.random.default_rng(0)
    xs = rng.exponential(0.01, 500)
    h, jh = Histogram(), JHistogram()
    for x in xs:
        h.add(float(x))
        jh.add(float(x))
    assert h.summary() == jh.summary()
    spec = "step@3+5,alloc~0.3,swap_in@1"
    fp, jfp = FaultPlan.parse(spec, seed=4), JFaultPlan.parse(spec, seed=4)
    for seam in ("step", "alloc", "swap_in") * 10:
        assert fp.fire(seam) == jfp.fire(seam)
    assert fp.summary() == jfp.summary()
    dumps = []
    for cls in (Tracer, JTracer):
        ticks = iter(range(1000))
        tr = cls(clock=lambda: next(ticks) * 1e-3)
        tr.thread_name(0, "group0")
        with tr.span("tick", step=0):
            tr.begin_async("queued", 7, rid=7)
            with tr.span("admit", rid=7):
                tr.end_async("queued", 7)
            tr.instant("shed", rid=3)
            tr.counter("free_blocks", 5)
        dumps.append(tr.dumps())
    assert dumps[0] == dumps[1]


# ---------------------------------------------------------------------------
# Scheduled generation: the port against the reference, and solo ≡ scheduled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafter,verifier", [
    ("ngram", "bf16"), ("ngram", "w4a8"), ("vanilla", "w8a8"), ("pruned", "bf16"),
    ("pruned", "w4a8"), ("ngram-tree", "w8a8")])
def test_scheduled_tokens_match_jax(drafter, verifier):
    """5 requests through 2 slots over the contiguous cache: every request's
    greedy tokens equal the reference's exactly (f32 reduced config)."""
    got, eng = port_scheduled(drafter, verifier, "contiguous")
    for r, want in zip(got, jax_scheduled_tokens(drafter, verifier, "contiguous")):
        np.testing.assert_array_equal(r.tokens, want)
        assert not r.bad and r.steps >= 1
    assert eng.group_stats[0]["slots"] == 2


def _solo(eng, params, req):
    alone = GenerationRequest(req.prompt, req.max_new_tokens, temperature=req.temperature,
                              seed=req.seed)
    return eng.generate_requests(params, [alone], batch_slots=1)[0]


@pytest.mark.parametrize("drafter,verifier,temperature", [
    ("ngram", "w8a8", 0.0), ("ngram", "bf16", 0.8), ("pruned", "bf16", 0.8),
    ("ngram-tree", "w4a8", 0.7)])
def test_scheduled_matches_solo_in_port(drafter, verifier, temperature):
    """5 requests through 2 slots (slots recycled, rows reset in place):
    every stream equals serving that request alone, also when sampling
    (each row draws from its own request's generator)."""
    model, params = port_setup()
    reqs = request_mix(temperature=temperature)
    got, eng = port_scheduled(drafter, verifier, "contiguous", reqs=reqs)
    for r, req in zip(got, reqs):
        np.testing.assert_array_equal(r.tokens, _solo(eng, params, req).tokens)


def test_mixed_temperatures_and_streaming():
    """Two temperature groups are served one after the other; streamed
    deltas concatenate to each request's tokens; telemetry counts them."""
    model, params = port_setup()
    reqs = request_mix()
    reqs[1].temperature, reqs[3].temperature = 0.9, 0.9
    eng = SpecEngine(model, SpecConfig(**JSCFG), drafter="ngram", verifier="bf16")
    streamed = {}
    out = eng.generate_requests(params, reqs, batch_slots=2,
                                on_tokens=lambda i, t: streamed.setdefault(i, []).append(t))
    assert [g["temperature"] for g in eng.group_stats] == [0.0, 0.9]
    for i, r in enumerate(out):
        assert r.new_tokens == reqs[i].max_new_tokens
        np.testing.assert_array_equal(np.concatenate(streamed[i]), r.tokens)
    (key,) = eng.telemetry.keys
    assert eng.telemetry.summary()[key]["committed_tokens"] == sum(r.new_tokens for r in out)


def _state_pointers(state):
    ptrs = {}

    def walk(path, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{path}/{k}", v)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(f"{path}/{i}", v)
        elif isinstance(x, torch.Tensor):
            ptrs[path] = (x.data_ptr(), tuple(x.shape))
    walk("", {k: v for k, v in state.items() if k != "generators"})
    return ptrs


@pytest.mark.parametrize("layout,drafter", [("contiguous", "pruned"), ("paged", "pruned"),
                                            ("paged", "ngram")])
def test_admission_allocates_no_new_state_tensors(layout, drafter):
    """The eager counterpart of the reference's ``step_traces == 1``:
    admitting requests (slot recycling included, prefix hits on the paged
    layout) writes the state's tensors in place — every state tensor keeps
    its storage and shape across admissions."""
    model, params = port_setup()
    eng = SpecEngine(model, SpecConfig(**JSCFG, kv_layout=layout, kv_block_size=8),
                     drafter=drafter, verifier="bf16")
    reqs = request_mix()
    group = eng.serving_group(eng._prepare_cached(params), reqs, batch_slots=2)
    state = group.state
    before = _state_pointers(state)
    for j, slot in enumerate((0, 1, 0, 1)):
        if j >= 2 and group.ctx is not None:
            state = group.hooks["release"](state, slot, j - 2)
        state = group.hooks["admit"](state, slot, j)
        assert _state_pointers(state) == before
        assert int(state["length"][slot]) == reqs[j].prompt.size
    if group.ctx is not None:
        assert group.ctx.shared_blocks > 0    # the later prompts hit the prefix cache
        group.ctx.check_invariants()


def test_serve_cli_paged_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "smollm-135m", "--reduced", "--device", "cpu", "--verifier", "w8a8",
                        "--kv-layout", "paged", "--kv-block-size", "16", "--gamma", "3",
                        "--batch", "3", "--prompt-len", "24", "--new-tokens", "6"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "kv_layout=paged" in p.stdout and "mean acceptance length L=" in p.stdout
    assert "served 3 requests" in p.stdout
