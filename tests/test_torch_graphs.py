"""The port's compiled decode step (``serving/graphs.py``) against the
reference's ``step_traces``, on the CPU.

The reference jits the decode step once and counts its traces; the port
runs a program's first step eagerly and, on the card, captures the second
as a CUDA graph and replays it.  ``step_traces`` counts programs built in
both, so the reference's assertions carry over, each beside its
counterpart:

* admission from a queue 3x the slots builds one program
  (``tests/test_continuous_batching.py::test_admission_does_not_retrace_decode_step``);
* paged serving builds one per temperature group
  (``tests/test_paged_cache.py::_serve_both_layouts``);
* preemption with swap-in, and random arrivals with prefix sharing, build
  one (``tests/test_prefix_sharing.py::test_preempt_resume_bit_identity_all_combos``,
  ``::test_scheduler_fuzz_random_interleavings``).

Also: every state tensor and generator keeps its storage across steps,
admissions, preemption and resume (what a replayed graph needs);
``graphs=False`` gives the default's tokens; and a replay adds the launches
its capture counted, once (a stand-in graph, since the CPU captures none).
The card's side (replay ≡ eager, bit for bit) is in ``test_torch_card.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.config import SpecConfig as JSpecConfig
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.request import GenerationRequest as JRequest
from repro_torch.core import paged_cache as pc
from repro_torch.core.config import SpecConfig
from repro_torch.kernels import ops
from repro_torch.serving import graphs
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from test_torch_batching import (JSCFG, _state_pointers, jax_setup,  # noqa: F401
                                 one_torch_thread, port_setup, request_mix)
from test_torch_paged import Harness

# a queue 3x the two slots, as the reference's admission test
QUEUE = ((5, 6, 11), (4, 9, 22), (3, 7, 33), (2, 5, 44), (4, 3, 55), (3, 8, 66))


def test_admission_does_not_retrace_decode_step():
    """Six requests through two slots: every admission writes the state in
    place, so the whole run is one program, as the reference's one trace."""
    jmodel, jparams = jax_setup()
    jeng = JSpecEngine(jmodel, JSpecConfig(**JSCFG), drafter="ngram", verifier="bf16")
    assert jeng.step_traces == 0
    jeng.generate_requests(jparams, request_mix(JRequest, spec=QUEUE), batch_slots=2)

    model, params = port_setup()
    eng = SpecEngine(model, SpecConfig(**JSCFG), drafter="ngram", verifier="bf16")
    assert eng.step_traces == 0
    results = eng.generate_requests(params, request_mix(spec=QUEUE), batch_slots=2)
    assert all(r.new_tokens == r.request.max_new_tokens for r in results)
    assert eng.step_traces == jeng.step_traces == 1


def test_paged_builds_one_program_per_temperature_group():
    """Paged admission and block top-up build no program: one per
    temperature group, as the reference compiles one per group."""
    def mixed(cls):
        reqs = request_mix(cls)
        reqs[1].temperature = reqs[3].temperature = 0.8
        return reqs

    scfg = dict(JSCFG, kv_layout="paged", kv_block_size=8)
    jmodel, jparams = jax_setup()
    jeng = JSpecEngine(jmodel, JSpecConfig(**scfg), drafter="ngram", verifier="bf16")
    jeng.generate_requests(jparams, mixed(JRequest), batch_slots=2)

    model, params = port_setup()
    eng = SpecEngine(model, SpecConfig(**scfg), drafter="ngram", verifier="bf16")
    assert eng.step_traces == 0
    eng.generate_requests(params, mixed(GenerationRequest), batch_slots=2)
    assert [g["temperature"] for g in eng.group_stats] == [0.0, 0.8]
    assert eng.step_traces == jeng.step_traces == 2


def _preempt_run(drafter, verifier, temp):
    """The preemption workload of ``test_torch_paged``: a victim fills the
    pool, two shared-prefix arrivals evict it, it resumes.  Checks that the
    state keeps every tensor and generator after each tick."""
    rng = np.random.default_rng(17)
    pat, other = rng.integers(0, 256, 6), rng.integers(0, 256, 18)
    reqs = [GenerationRequest(other, max_new_tokens=10, seed=1, priority=2),
            GenerationRequest(np.tile(pat, 2), max_new_tokens=4, seed=2),
            GenerationRequest(np.concatenate([np.tile(pat, 2), pat[:3]]), max_new_tokens=5,
                              seed=3)]
    d_vic = pc.blocks_for_tokens(pc.request_demand_tokens(18, 10, 3), 8)
    h = Harness(reqs, drafter=drafter, verifier=verifier, temp=temp,
                pool_blocks=1 + d_vic + 1)
    before = _state_pointers(h.state)
    gens = list(h.state["generators"])
    h.submit(0)
    for _ in range(100):
        if h.sched.steps == 2:
            h.submit(1)
            h.submit(2)
        if h.sched.steps > 2 and not h.sched.busy:
            break
        h.tick()
        assert _state_pointers(h.state) == before
        assert all(a is b for a, b in zip(h.state["generators"], gens))
    assert h.sched.preemptions >= 1 and h.ctx.swaps >= 1 and not h.ctx.swap
    return h


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("drafter,verifier", [("ngram", "w8a8"), ("pruned", "bf16")])
def test_preemption_and_swap_in_build_no_program(drafter, verifier, temp):
    """Preemption copies a row to the host and swap-in writes it back in
    place (its generator reseeded from the snapshot): one program for the
    whole episode, and the state's buffers never change."""
    h = _preempt_run(drafter, verifier, temp)
    assert h.ctx.snapshot()["swap_in_blocks"] > 0
    assert h.eng.step_traces == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_random_arrivals_with_prefix_sharing_build_one_program(seed):
    """Seeded random interleavings of submit and tick over a tight pool with
    shared-prefix families: admissions, prefix hits, forks, preemption and
    resume in any order build one program."""
    rng = np.random.default_rng(100 + seed)
    a, b = rng.integers(0, 256, 8), rng.integers(0, 256, 8)
    prompts = [np.tile(a, 2), np.tile(a, 2), np.concatenate([np.tile(a, 2), a[:5]]),
               np.tile(b, 2), np.concatenate([b, b[:4]]), rng.integers(0, 256, 14)]
    order = rng.permutation(len(prompts))
    reqs = [GenerationRequest(prompts[i], max_new_tokens=int(rng.integers(3, 7)), seed=int(i),
                              priority=int(rng.integers(0, 3))) for i in order]
    demand = max(pc.blocks_for_tokens(pc.request_demand_tokens(r.prompt.size,
                                                               r.max_new_tokens, 3), 8)
                 for r in reqs)
    h = Harness(reqs, drafter="ngram", verifier="bf16", temp=0.0, pool_blocks=1 + demand + 2)
    before = _state_pointers(h.state)
    k = 0
    while k < len(reqs) or h.sched.busy:
        while k < len(reqs) and rng.random() < 0.55:
            h.submit(k)
            k += 1
        if k < len(reqs) and not h.sched.busy:
            continue
        h.tick()
        assert _state_pointers(h.state) == before
    assert len(h.sched.results) == len(reqs)
    assert h.ctx.shared_blocks > 0
    assert h.eng.step_traces == 1
    assert h.ctx.pool.unique_allocated == 0


@pytest.mark.parametrize("layout,drafter,temperature", [
    ("contiguous", "ngram-tree", 0.0), ("contiguous", "pruned", 0.9),
    ("paged", "ngram", 0.9)])
def test_graphs_false_gives_the_default_tokens(layout, drafter, temperature):
    """The check keyword changes nothing on the CPU, where every step runs
    eagerly: the same tokens, the same programs counted."""
    model, params = port_setup()
    scfg = SpecConfig(**{**JSCFG, "temperature": temperature}, kv_layout=layout,
                      kv_block_size=8)
    out = {}
    for g in (True, False):
        eng = SpecEngine(model, scfg, drafter=drafter, verifier="w8a8", graphs=g)
        res = eng.generate_requests(params, request_mix(), batch_slots=2)
        gen = eng.generate(params, torch.from_numpy(np.tile(np.arange(6), (2, 3))), 5)
        out[g] = ([r.tokens for r in res], eng.step_traces, eng._programs.captures,
                  gen.tokens, gen.capture_s)
    for a, b in zip(out[True][0], out[False][0]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(out[True][3], out[False][3])
    assert out[True][1] == out[False][1] == 2              # one group + one generate
    assert out[True][2] == out[False][2] == 0              # nothing captured on the CPU
    assert out[True][4] == out[False][4] == 0.0


class _Params:
    """Stand-in params (the step programs hold them weakly)."""


class _StandInGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        self.replays += 1


def test_replay_adds_the_launches_its_capture_counted(monkeypatch):
    """A capture's wrapper counts are kept out of ``LAUNCHES`` and added
    once per replay; the first step of a program counts as it launches."""
    made = []

    def new_graph():
        made.append(_StandInGraph())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None, **kw: _NoCapture())
    monkeypatch.setattr(graphs.StepPrograms, "_on_card", staticmethod(lambda state: True))

    def step(params, state):             # counts as a step of two kernels would
        ops.LAUNCHES["int8_matmul"] += 3
        ops.LAUNCHES["flash_decode"] += 1
        return state

    programs = graphs.StepPrograms()
    counted = programs.counted(step)
    params = _Params()
    state = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
             "length": torch.zeros(2, dtype=torch.int32),
             "generators": [torch.Generator(), torch.Generator()]}
    ops.reset_launch_counts()
    ops.LAUNCHES["smooth_quant"] += 5
    for n in range(1, 5):
        assert counted(params, state) is state
        assert ops.launch_counts() == {"smooth_quant": 5, "int8_matmul": 3 * n,
                                       "flash_decode": n}
    (graph,) = made
    assert graph.replays == 3 and graph.generators == state["generators"]
    assert programs.step_traces == 1 and programs.captures == 1
    # other params: another program, first step eager, then its own capture
    other = _Params()
    counted(other, state)
    counted(other, state)
    assert programs.step_traces == 2 and programs.captures == 2 and len(made) == 2
    assert ops.launch_counts()["int8_matmul"] == 3 * 6
    # the programs hold params weakly: a dead params object's program is
    # never replayed, even if a new object gets its id
    key = graphs.StepPrograms._key(step, other, state)
    ref = programs._programs[key].params
    del other
    assert ref() is None
    ops.reset_launch_counts()


class _NoCapture:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_launches_apart_restores_the_counters():
    ops.reset_launch_counts()
    ops.LAUNCHES["x"] += 2
    with ops.launches_apart() as got:
        ops.LAUNCHES["int8_matmul"] += 3
        ops.LAUNCHES["x"] += 1
    assert got == {"int8_matmul": 3, "x": 1}
    assert ops.launch_counts() == {"x": 2}
    ops.add_launches(got)
    assert ops.launch_counts() == {"x": 3, "int8_matmul": 3}
    ops.reset_launch_counts()
