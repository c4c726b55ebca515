"""The port's serving front-end (``repro_torch/serving/server.py``) against
the JAX package's ``ServingLoop``, on the CPU (``smollm-135m`` ``.reduced()``,
f32, the same bridged weights on both sides).

Both loops run one open-loop scenario on a virtual clock (the reference's
``tests/test_faults.py::_run`` pattern: 0.25 s per decode step): requests
arrive at t = 0 and after two polls, with priorities and deadlines (two
of them hopeless, so shedding fires), through two slots, with
``degrade_on_overload`` (a tree engine's arrivals go to a chain lane once
the backlog reaches the slots).  At T = 0, for (ngram, w8a8),
(ngram-tree, w8a8) and (ngram, bf16), contiguous and paged, and under EDF
and FIFO admission, the port gives the reference's

* handle statuses, streamed chunks and result tokens, bit for bit;
* admission order and shed set (every lane's scheduler events);
* ``ServerMetrics.summary()`` (counters, virtual-clock TTFT/ITL/queue/
  service summaries, acceptance, robustness, KV cache) and byte-equal
  ``expose_text()``.

Degrading tree → chain gives the tree engine's tokens.  At T > 0 the port
is held against itself: the streamed chunks concatenate to the result, and
EDF admission gives FIFO's tokens.  The threaded ``StreamingServer`` serves
the same tokens from a caller thread.
"""
import functools

import numpy as np
import pytest

from repro.core.config import SpecConfig as JSpecConfig
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.request import GenerationRequest as JRequest
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import ServingLoop as JServingLoop
from repro_torch.core.config import SpecConfig
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from repro_torch.serving.server import ServerConfig, ServingLoop, StreamingServer
from test_torch_batching import jax_setup, one_torch_thread, port_setup  # noqa: F401

COMBOS = [("ngram", "w8a8"), ("ngram-tree", "w8a8"), ("ngram", "bf16")]
SCFG = dict(temperature=0.0, gamma=3, tree_branches=(2, 1, 1), kv_block_size=8)
SERVER = dict(batch_slots=2, max_prompt_len=32, max_new_tokens=12, degrade_on_overload=True,
              overload_factor=1.0)
STEP_COST = 0.25                  # virtual seconds per decode step

# (pattern reps, budget, seed, priority, deadline_s): the first five arrive at
# t = 0, the rest after two polls; two deadlines cannot be met
EARLY = ((4, 8, 11, 0, None), (3, 12, 22, 0, 6.0), (5, 6, 33, 1, None),
         (2, 10, 44, 1, 0.3), (4, 7, 55, 0, 4.0))
LATE = ((3, 9, 66, 0, 2.5), (5, 5, 77, 0, 0.1), (2, 6, 88, 1, None))


def scenario(cls, V=256, temperature=None):
    rng = np.random.default_rng(3)
    pat = rng.integers(0, V, 6)

    def make(spec):
        return [cls(np.tile(pat, k), max_new_tokens=n, seed=s, priority=p, deadline_s=d,
                    temperature=temperature)
                for k, n, s, p, d in spec]
    return make(EARLY), make(LATE)


def drive(loop, early, late, clock):
    """Submit ``early``, poll twice, submit ``late``, drain; the clock moves
    STEP_COST per decode step, after each poll."""
    handles = [loop.submit(r) for r in early]
    polls = 0
    while loop.busy or polls < 2:
        if polls == 2:
            handles += [loop.submit(r) for r in late]
        before = loop.total_steps
        loop.poll()
        clock[0] += (loop.total_steps - before) * STEP_COST
        polls += 1
        assert polls < 500, "serving loop did not drain"
    return handles


def lane_record(loop):
    """Per lane (in creation order): key, scheduler events and shed set."""
    return [(key, [(e.request_index, e.slot, e.admit_step, e.harvest_step, e.preempted,
                    e.failed) for e in lane.sched.events], sorted(lane.sched.shed_indices))
            for key, lane in loop._lanes.items()]


def outcome(loop, handles):
    return dict(
        status=[h.status for h in handles],
        chunks=[[c.tolist() for c in h.chunks] for h in handles],
        tokens=[None if h.status != "done" else h.result(0.0).tokens.tolist()
                for h in handles],
        degraded=[h.degraded for h in handles],
        lanes=lane_record(loop),
        summary=loop.metrics.summary(include_requests=True),
        prom=loop.metrics.expose_text())


@functools.lru_cache(maxsize=None)
def jax_outcome(drafter, verifier, layout, admission):
    jmodel, jparams = jax_setup()
    eng = JSpecEngine(jmodel, JSpecConfig(**SCFG, kv_layout=layout), drafter=drafter,
                      verifier=verifier)
    clock = [0.0]
    loop = JServingLoop(eng, jparams, JServerConfig(**SERVER, admission=admission),
                        clock=lambda: clock[0])
    handles = drive(loop, *scenario(JRequest), clock)
    return outcome(loop, handles)


def port_loop(drafter, verifier, layout, admission="edf", **server):
    model, params = port_setup()
    eng = SpecEngine(model, SpecConfig(**SCFG, kv_layout=layout), drafter=drafter,
                     verifier=verifier)
    clock = [0.0]
    loop = ServingLoop(eng, params, ServerConfig(**{**SERVER, **server}, admission=admission),
                       clock=lambda: clock[0])
    return loop, clock


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("drafter,verifier", COMBOS, ids=[f"{d}-{v}" for d, v in COMBOS])
def test_serving_loop_matches_jax(drafter, verifier, layout):
    want = jax_outcome(drafter, verifier, layout, "edf")
    loop, clock = port_loop(drafter, verifier, layout)
    handles = drive(loop, *scenario(GenerationRequest), clock)
    got = outcome(loop, handles)
    assert got["status"] == want["status"]
    assert got["chunks"] == want["chunks"]
    assert got["tokens"] == want["tokens"]
    assert got["degraded"] == want["degraded"]
    assert got["lanes"] == want["lanes"]
    assert got["summary"] == want["summary"]
    assert got["prom"] == want["prom"]
    # the scenario reaches what it is meant to
    c = got["summary"]["counters"]
    assert c["shed"] >= 1 and c["completed"] + c["shed"] == len(EARLY) + len(LATE)
    assert all(v == 0 for v in got["summary"]["robustness"].values())
    loop.metrics.check_conservation()
    for lane in loop._lanes.values():
        lane.sched.check_conservation()
        if lane.ctx is not None:
            lane.ctx.pool.check_invariants()
            assert lane.ctx.pool.unique_allocated == 0
    for h in handles:
        if h.status == "done":
            np.testing.assert_array_equal(h.collected(), h.result(0.0).tokens)
    if drafter == "ngram-tree":
        assert c["degraded"] > 0 and len(loop._lanes) == 2


def test_fifo_admission_matches_jax():
    """FIFO pops by (priority, arrival): a different admission order and
    shed set from EDF's, the reference's in both."""
    want = jax_outcome("ngram", "w8a8", "paged", "fifo")
    loop, clock = port_loop("ngram", "w8a8", "paged", admission="fifo")
    got = outcome(loop, drive(loop, *scenario(GenerationRequest), clock))
    assert got == want
    assert got["lanes"] != jax_outcome("ngram", "w8a8", "paged", "edf")["lanes"]


def test_degrade_tree_to_chain_keeps_the_tree_tokens():
    """Arrivals routed to the chain lane under overload get the tokens the
    tree engine alone gives (T = 0: drafting is lossless)."""
    model, params = port_setup()
    early, late = scenario(GenerationRequest)
    reqs = early + late
    loop, clock = port_loop("ngram-tree", "w8a8", "contiguous", shed_late=False)
    handles = drive(loop, early, late, clock)
    assert any(h.degraded for h in handles) and not all(h.degraded for h in handles)
    eng = SpecEngine(model, SpecConfig(**SCFG), drafter="ngram-tree", verifier="w8a8")
    for h, r in zip(handles, eng.generate_requests(params, reqs, batch_slots=2)):
        assert h.status == "done"
        np.testing.assert_array_equal(h.result(0.0).tokens, r.tokens)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sampling_streams_concat_and_edf_keeps_tokens(layout):
    """T > 0: each request's chunks concatenate to its result, and EDF
    admission gives FIFO's tokens (per-request generators)."""
    early, late = scenario(GenerationRequest, temperature=0.8)
    got = {}
    for admission in ("edf", "fifo"):
        loop, clock = port_loop("ngram", "w8a8", layout, admission=admission,
                                shed_late=False)
        handles = drive(loop, early, late, clock)
        assert all(h.status == "done" for h in handles)
        for h in handles:
            np.testing.assert_array_equal(h.collected(), h.result(0.0).tokens)
        got[admission] = ([h.result(0.0).tokens.tolist() for h in handles],
                          lane_record(loop))
    assert got["edf"][0] == got["fifo"][0]
    assert got["edf"][1] != got["fifo"][1]          # the admission order did change


def test_streaming_server_serves_the_loop_tokens():
    """The threaded server: submits and per-token consumption from this
    thread, the poll loop on its own; tokens as the virtual-clock loop's."""
    model, params = port_setup()
    early, late = scenario(GenerationRequest)
    reqs = [r for r in early + late if r.deadline_s is None or r.deadline_s > 1.0]
    want = SpecEngine(model, SpecConfig(**SCFG), drafter="ngram",
                      verifier="w8a8").generate_requests(params, reqs, batch_slots=2)
    eng = SpecEngine(model, SpecConfig(**SCFG), drafter="ngram", verifier="w8a8")
    cfg = ServerConfig(**{**SERVER, "degrade_on_overload": False}, shed_late=False)
    with StreamingServer(eng, params, cfg) as srv:
        handles = [srv.submit(r) for r in reqs]
        for h, w in zip(handles, want):
            streamed = np.concatenate(list(h.tokens()))
            np.testing.assert_array_equal(streamed, h.result(timeout=120.0).tokens)
            np.testing.assert_array_equal(streamed, w.tokens)
    srv.metrics.check_conservation()
    assert srv.metrics.counters["completed"] == len(reqs)
    assert srv.metrics.summary()["latency"]["ttft_s"]["n"] == len(reqs)
