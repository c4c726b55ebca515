"""Failure containment of the port's serving front-end on the CPU: the
reference's seeded fault matrix (``tests/test_faults.py``) run on
``repro_torch.serving.server``, and held against the JAX ``ServingLoop``
under the same ``FaultPlan`` (``smollm-135m`` ``.reduced()``, f32, bridged
weights, paged KV, a virtual clock).

* Every scenario of the matrix (step exception, transient NaN verify,
  sticky quantized-weight corruption, an allocation failure, a malformed
  submit) × (ngram, bf16), (ngram, w8a8), (ngram-tree, w8a8): the loop
  drains, conservation holds at both levels, every KV block comes back,
  and untouched requests are bit-identical to the fault-free twin.
* Paged W8A8: statuses, tokens and the whole ``ServerMetrics.summary()``
  (guardrail counters included) equal the reference's for each scenario.
* ``step_traces`` after a fault: the port builds a program per params
  object, so it counts the reference's traces plus one per poisoned view
  and one per lane repair (ROADMAP §3).
* The guard reruns the in-place step: a transient trip leaves every
  state tensor where it was and gives the untripped tokens.
* Swap-in corruption, stalls with ``request_timeout_s``, cancel,
  ``recover`` (which frees the torn-down lanes' programs), the
  supervisor's restart and abort, ``result`` timeouts and ``shutdown``.
* The CLI: ``--serve --device cpu --reduced`` with ``--fault-plan``,
  ``--trace-out``, ``--metrics-out`` and ``--prom-out`` writes its files.
"""
import json

import numpy as np
import pytest

from repro.core.config import SpecConfig as JSpecConfig
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.request import GenerationRequest as JRequest
from repro.serving.server import ServerConfig as JServerConfig
from repro.serving.server import ServingLoop as JServingLoop
from repro_torch.core.config import SpecConfig
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.faults import (
    FaultPlan,
    InjectedFault,
    LaneCrashed,
    RequestCancelled,
    RequestTimeout,
    VerifierNaNError,
)
from repro_torch.serving.request import GenerationRequest
from repro_torch.serving.server import ServerConfig, ServingLoop, StreamingServer
from test_torch_batching import jax_setup, one_torch_thread, port_setup  # noqa: F401

COMBOS = [("ngram", "bf16"), ("ngram", "w8a8"), ("ngram-tree", "w8a8")]
SCENARIOS = {                        # the reference's matrix (tests/test_faults.py)
    "step_exception": "step@1",
    "nan_transient": "nan_verify@1",
    "quant_sticky": "quant_corrupt@1",
    "alloc_failure": "alloc@0",
    "malformed_submit": "submit@1",
}
SCFG = dict(temperature=0.0, gamma=3, tree_branches=(2, 1, 1), kv_layout="paged",
            kv_block_size=8, kv_pool_blocks=24)
SERVER = dict(batch_slots=2, max_prompt_len=16, max_new_tokens=16)


def requests(cls, V=256, seed=3):
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, V, 6)
    return [cls(np.tile(pat, k), max_new_tokens=m, seed=s)
            for k, m, s in [(2, 8, 11), (1, 10, 22), (2, 6, 33), (1, 8, 44)]]


_ENGINES = {}


def engine(drafter, verifier, fresh=False):
    key = (drafter, verifier)
    if fresh or key not in _ENGINES:
        model, _ = port_setup()
        eng = SpecEngine(model, SpecConfig(**SCFG), drafter=drafter, verifier=verifier)
        if fresh:
            return eng
        _ENGINES[key] = eng
    return _ENGINES[key]


def run(loop_cls, eng, params, reqs, *, faults=None, cfg_kw=None, cfg_cls=ServerConfig,
        max_polls=2000):
    """Drive a virtual-clock loop to drain (the reference's ``_run``); the
    poll bound is the no-deadlock assertion."""
    clock = [0.0]
    loop = loop_cls(eng, params, cfg_cls(**SERVER, **(cfg_kw or {})),
                    clock=lambda: clock[0], faults=faults,
                    stall_hook=lambda s: clock.__setitem__(0, clock[0] + s))
    handles = [loop.submit(r) for r in reqs]
    polls = 0
    while loop.busy:
        before = loop.total_steps
        loop.poll()
        clock[0] += (loop.total_steps - before) * 0.25
        polls += 1
        assert polls < max_polls, "serving loop did not drain (deadlock?)"
    return loop, handles


def port_run(drafter, verifier, *, faults=None, eng=None, **kw):
    _, params = port_setup()
    eng = eng if eng is not None else engine(drafter, verifier)
    return run(ServingLoop, eng, params, requests(GenerationRequest), faults=faults, **kw)


def jax_run(eng, *, faults=None):
    _, jparams = jax_setup()
    return run(JServingLoop, eng, jparams, requests(JRequest), faults=faults,
               cfg_cls=JServerConfig)


def jax_engine(drafter, verifier):
    jmodel, _ = jax_setup()
    return JSpecEngine(jmodel, JSpecConfig(**SCFG), drafter=drafter, verifier=verifier)


_BASELINES = {}


def baseline(drafter, verifier):
    key = (drafter, verifier)
    if key not in _BASELINES:
        loop, handles = port_run(drafter, verifier)
        assert all(h.status == "done" for h in handles)
        assert all(v == 0 for v in loop.metrics.robustness.values())
        _BASELINES[key] = [h.result(0.0).tokens for h in handles]
    return _BASELINES[key]


def check_contained(loop, handles, base):
    loop.metrics.check_conservation()
    c = loop.metrics.counters
    assert c["completed"] + c["shed"] + c["failed"] == c["submitted"] == len(handles)
    for lane in loop._lanes.values():
        lane.sched.check_conservation()
        if lane.ctx is not None:
            lane.ctx.pool.check_invariants()
            assert lane.ctx.pool.unique_allocated == 0
    for h, b in zip(handles, base):
        assert h.status in ("done", "shed", "failed")
        if h.status == "done" and h.rid not in loop.affected:
            np.testing.assert_array_equal(h.result(0.0).tokens, b)


@pytest.mark.parametrize("drafter,verifier", COMBOS, ids=[f"{d}-{v}" for d, v in COMBOS])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fault_matrix_contains_and_conserves(scenario, drafter, verifier):
    base = baseline(drafter, verifier)
    loop, handles = port_run(drafter, verifier,
                             faults=FaultPlan.parse(SCENARIOS[scenario], seed=7))
    check_contained(loop, handles, base)
    rb = loop.metrics.summary()["robustness"]
    c = loop.metrics.counters
    failed = [h for h in handles if h.status == "failed"]
    if scenario == "step_exception":
        assert c["failed"] >= 1 and rb["request_faults"] >= 1
        with pytest.raises(InjectedFault):
            failed[0].result(timeout=0.0)
    elif scenario == "nan_transient":
        # the retry from the restored pre-step registers replays the step
        # bit for bit: every token as the twin's
        assert all(h.status == "done" for h in handles) and not loop.affected
        assert rb["verify_nan_trips"] >= 1 and rb["retry_rescued_rows"] >= 1
        assert rb["bf16_rescued_rows"] == 0
    elif scenario == "quant_sticky":
        assert all(h.status == "done" for h in handles)
        assert rb["verify_nan_trips"] >= 1 and rb["bf16_rescued_rows"] >= 1
        assert rb["reprepares"] >= 1
        if verifier == "bf16":       # the fallback runs the same weights
            for h, b in zip(handles, base):
                np.testing.assert_array_equal(h.result(0.0).tokens, b)
        assert 'serve_robustness_total{event="verify_nan_trips"}' in \
            loop.metrics.expose_text()
    elif scenario == "alloc_failure":
        assert c["failed"] == 1 and rb["request_faults"] == 1
        with pytest.raises(InjectedFault, match="alloc failure"):
            failed[0].result(timeout=0.0)
    elif scenario == "malformed_submit":
        assert c["failed"] == 1 and rb["rejected"] == 1
        with pytest.raises(ValueError, match="injected malformed"):
            failed[0].result(timeout=0.0)


_JAX_PAGED_W8A8 = []


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_w8a8_faults_match_jax(scenario):
    """The same FaultPlan on both loops: statuses, tokens, the fault log and
    the whole metrics summary (guardrail counters included) are equal."""
    if not _JAX_PAGED_W8A8:
        _JAX_PAGED_W8A8.append(jax_engine("ngram", "w8a8"))
    jplan = JFaultPlan.parse(SCENARIOS[scenario], seed=7)
    jloop, jhandles = jax_run(_JAX_PAGED_W8A8[0], faults=jplan)
    plan = FaultPlan.parse(SCENARIOS[scenario], seed=7)
    loop, handles = port_run("ngram", "w8a8", faults=plan)
    assert [h.status for h in handles] == [h.status for h in jhandles]
    for h, jh in zip(handles, jhandles):
        assert type(h.error).__name__ == type(jh.error).__name__
        if h.status == "done":
            np.testing.assert_array_equal(h.result(0.0).tokens,
                                          np.asarray(jh.result(0.0).tokens))
    assert plan.log == jplan.log and plan.summary() == jplan.summary()
    assert loop.affected == jloop.affected
    assert loop.metrics.summary(include_requests=True) == \
        jloop.metrics.summary(include_requests=True)


@pytest.mark.parametrize("scenario,extra", [("nan_transient", 1), ("quant_sticky", 2)])
def test_step_traces_after_a_fault(scenario, extra):
    """The reference's ``jit`` reuses its trace for a poisoned params tree
    and for a re-prepared one; the port builds a program per params object.
    So after a fault the port counts the reference's traces plus one per
    poisoned view (``nan_verify``, ``quant_corrupt``) and one per repair."""
    jeng = jax_engine("ngram", "w8a8")
    jloop, _ = jax_run(jeng, faults=JFaultPlan.parse(SCENARIOS[scenario], seed=7))
    eng = engine("ngram", "w8a8", fresh=True)
    plan = FaultPlan.parse(SCENARIOS[scenario], seed=7)
    loop, _ = port_run("ngram", "w8a8", faults=plan, eng=eng)
    rb = loop.metrics.robustness
    poisoned = plan.fired["nan_verify"] + plan.fired["quant_corrupt"]
    assert poisoned + rb["reprepares"] == extra
    assert eng.step_traces == jeng.step_traces + poisoned + rb["reprepares"]
    # the lane's step, plus the bf16 twin after a rescue, as the reference
    assert jeng.step_traces == 1 + (rb["bf16_rescued_rows"] > 0)


def test_transient_trip_reruns_in_place():
    """A tripped step is rerun into the state's own tensors (a captured
    step program needs them): after a transient NaN every state tensor and
    generator is the one it was, and the tokens are the untripped run's."""
    base = baseline("ngram", "w8a8")
    _, params = port_setup()
    clock = [0.0]
    loop = ServingLoop(engine("ngram", "w8a8"), params, ServerConfig(**SERVER),
                       clock=lambda: clock[0], faults=FaultPlan.parse("nan_verify@1+3"))
    handles = [loop.submit(r) for r in requests(GenerationRequest)]
    loop.poll()
    lane = next(iter(loop._lanes.values()))
    st = lane.state
    ptrs = [t.data_ptr() for t in (st["tokens"], st["length"], *st["stats"].values())]
    gens = list(st["generators"])
    loop.drain()
    assert [t.data_ptr() for t in (st["tokens"], st["length"],
                                   *st["stats"].values())] == ptrs
    assert lane.state is st and st["generators"] == gens
    assert loop.metrics.robustness["retry_rescued_rows"] >= 2
    for h, b in zip(handles, base):
        np.testing.assert_array_equal(h.result(0.0).tokens, b)


def test_swap_in_corruption_fails_only_resumed_request():
    """A preempted request resumes through a corrupted snapshot: retry and
    the bf16 fallback both see NaN KV, so exactly that request fails with
    ``VerifierNaNError``; the others finish as in the clean run."""
    model, params = port_setup()
    scfg = SpecConfig(temperature=0.0, gamma=3, kv_layout="paged", kv_block_size=8,
                      kv_pool_blocks=8)
    eng = SpecEngine(model, scfg, drafter="ngram", verifier="bf16")
    rng = np.random.default_rng(17)
    pat = rng.integers(0, 256, 6)
    other = rng.integers(0, 256, 18)
    victim = GenerationRequest(other, max_new_tokens=10, seed=1, priority=2)
    fam = [GenerationRequest(np.tile(pat, 2), max_new_tokens=4, seed=2),
           GenerationRequest(np.concatenate([np.tile(pat, 2), pat[:3]]), max_new_tokens=5,
                             seed=3)]

    def drive(faults):
        clock = [0.0]
        loop = ServingLoop(eng, params, ServerConfig(batch_slots=2, max_prompt_len=24,
                                                     max_new_tokens=16),
                           clock=lambda: clock[0], faults=faults)
        handles = [loop.submit(victim)]
        for _ in range(2):
            loop.poll()
            clock[0] += 0.25
        handles += [loop.submit(r) for r in fam]
        while loop.busy:
            loop.poll()
            clock[0] += 0.25
        return loop, handles

    clean, clean_handles = drive(None)
    assert next(iter(clean._lanes.values())).sched.preemptions >= 1
    loop, handles = drive(FaultPlan({"swap_in": {"p": 1.0}}, seed=0))
    assert handles[0].status == "failed" and isinstance(handles[0].error, VerifierNaNError)
    for h, ref in zip(handles[1:], clean_handles[1:]):
        np.testing.assert_array_equal(h.result(0.0).tokens, ref.result(0.0).tokens)
    loop.metrics.check_conservation()
    rb = loop.metrics.robustness
    assert rb["verify_nan_trips"] >= 1 and rb["unrescued_rows"] >= 1
    lane = next(iter(loop._lanes.values()))
    lane.ctx.pool.check_invariants()
    assert lane.ctx.pool.unique_allocated == 0


def test_stalled_lane_times_out_requests_not_callers():
    plan = FaultPlan({"stall": {"p": 1.0, "delay_s": 3.0}}, seed=0)
    loop, handles = port_run("ngram", "bf16", faults=plan,
                             cfg_kw={"request_timeout_s": 5.0})
    loop.metrics.check_conservation()
    assert loop.metrics.robustness["timeouts"] >= 1
    timed_out = [h for h in handles if h.status == "failed"]
    with pytest.raises(RequestTimeout, match="request_timeout_s"):
        timed_out[0].result(timeout=0.0)
    for lane in loop._lanes.values():
        assert lane.ctx.pool.unique_allocated == 0


def test_cancel_queued_and_running():
    _, params = port_setup()
    eng = engine("ngram", "bf16")
    reqs = requests(GenerationRequest)
    clock = [0.0]
    loop = ServingLoop(eng, params, ServerConfig(batch_slots=1, max_prompt_len=16,
                                                 max_new_tokens=16),
                       clock=lambda: clock[0])
    handles = [loop.submit(r) for r in reqs[:3]]
    handles[2].cancel()                  # still in the ingress queue
    loop.poll()
    clock[0] += 0.25
    handles[0].cancel()                  # running occupant
    loop.drain()
    for h in (handles[0], handles[2]):
        assert h.status == "failed"
        with pytest.raises(RequestCancelled):
            h.result(timeout=0.0)
    np.testing.assert_array_equal(handles[1].result(0.0).tokens,
                                  baseline("ngram", "bf16")[1])
    loop.metrics.check_conservation()
    assert loop.metrics.robustness["cancelled"] == 2
    assert next(iter(loop._lanes.values())).ctx.pool.unique_allocated == 0


def test_recover_requeues_queued_fails_running_and_frees_programs():
    """``recover``: running requests fail with ``LaneCrashed``, queued ones
    requeue and complete bit-identically (not re-counted), and the
    torn-down lane's step programs are dropped with its state."""
    _, params = port_setup()
    eng = engine("ngram", "bf16", fresh=True)
    clock = [0.0]
    loop = ServingLoop(eng, params, ServerConfig(batch_slots=1, max_prompt_len=16,
                                                 max_new_tokens=16),
                       clock=lambda: clock[0])
    handles = [loop.submit(r) for r in requests(GenerationRequest)]
    loop.poll()
    assert len(eng._programs._programs) == 1
    loop.recover(RuntimeError("simulated worker crash"))
    assert len(eng._programs._programs) == 0
    assert isinstance(handles[0].error, LaneCrashed)
    assert isinstance(handles[0].error.__cause__, RuntimeError)
    loop.drain()
    assert len(eng._programs._programs) == 1 and eng.step_traces == 2
    for h, b in zip(handles[1:], baseline("ngram", "bf16")[1:]):
        np.testing.assert_array_equal(h.result(0.0).tokens, b)
    c = loop.metrics.counters
    assert c["submitted"] == 4 and (c["completed"], c["failed"]) == (3, 1)


def test_supervisor_restarts_lane_after_poll_crash():
    _, params = port_setup()
    srv = StreamingServer(engine("ngram", "bf16"), params, ServerConfig(**SERVER),
                          faults=FaultPlan.parse("poll@1", seed=0), restart_backoff_s=0.01)
    handles = [srv.loop.submit(r) for r in requests(GenerationRequest)]
    with srv:
        for h in handles:
            try:
                h.result(timeout=120.0)
            except LaneCrashed:
                pass
    srv.metrics.check_conservation()
    assert srv.metrics.robustness["lane_restarts"] == 1
    assert any(h.status == "done" for h in handles)
    assert all(h.status == "done" or isinstance(h.error, LaneCrashed) for h in handles)


def test_supervisor_gives_up_and_aborts():
    _, params = port_setup()
    srv = StreamingServer(engine("ngram", "bf16"), params, ServerConfig(**SERVER),
                          faults=FaultPlan.parse("poll~1.0", seed=0),
                          restart_backoff_s=0.001, max_restarts=2)
    reqs = requests(GenerationRequest)
    h = srv.loop.submit(reqs[0])
    srv.start()
    with pytest.raises(LaneCrashed):
        h.result(timeout=120.0)
    with pytest.raises(LaneCrashed):
        srv.stop(drain=False)
    h2 = srv.loop.submit(reqs[1])           # a dead loop resolves at once
    assert h2.status == "failed"
    srv.metrics.check_conservation()
    assert srv.metrics.counters["submitted"] == 2


def test_result_timeout_and_shutdown():
    """``result(timeout)`` tells a live loop from a dead one; ``shutdown``
    sheds queued work, fails running work with ``RequestCancelled``, returns
    every block and leaves the loop serving."""
    _, params = port_setup()
    eng = engine("ngram", "bf16")
    reqs = requests(GenerationRequest)
    loop = ServingLoop(eng, params, ServerConfig(batch_slots=1, max_prompt_len=16,
                                                 max_new_tokens=16), clock=lambda: 0.0)
    h = loop.submit(reqs[0])
    with pytest.raises(TimeoutError, match="still queued"):
        h.result(timeout=0.01)
    loop.abort(RuntimeError("terminal crash"))
    with pytest.raises(RuntimeError, match="terminal crash"):
        h.result(timeout=0.0)

    loop = ServingLoop(eng, params, ServerConfig(batch_slots=1, max_prompt_len=16,
                                                 max_new_tokens=16), clock=lambda: 0.0)
    handles = [loop.submit(r) for r in reqs]
    loop.poll()
    loop.poll()
    loop.shutdown()
    assert not loop.busy and loop.dead is None
    with pytest.raises(RequestCancelled, match="shutdown"):
        handles[0].result(timeout=0.0)
    assert all(x.status == "shed" and x.result(0.0) is None for x in handles[1:])
    assert next(iter(loop._lanes.values())).ctx.pool.unique_allocated == 0
    h_new = loop.submit(reqs[0])
    loop.drain()
    np.testing.assert_array_equal(h_new.result(0.0).tokens, baseline("ngram", "bf16")[0])
    loop.metrics.check_conservation()


def test_serve_cli_writes_its_files(tmp_path, capsys):
    from repro_torch.launch import serve

    out = {k: tmp_path / f"{k}.out" for k in ("trace", "metrics", "prom")}
    r = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--serve",
                    "--requests", "5", "--arrival-rate", "50", "--batch", "2",
                    "--prompt-len", "24", "--new-tokens", "8", "--kv-layout", "paged",
                    "--kv-block-size", "8", "--fault-plan", "nan_verify@2,quant_corrupt@4",
                    "--trace-out", str(out["trace"]), "--metrics-out", str(out["metrics"]),
                    "--prom-out", str(out["prom"])])
    text = capsys.readouterr().out
    assert "served 5/5" in text and "verify_nan_trips=" in text
    assert all(h.status == "done" for h in r.handles)
    summary = json.loads(out["metrics"].read_text())
    assert summary == json.loads(json.dumps(r.summary))
    assert summary["robustness"]["bf16_rescued_rows"] > 0
    assert summary["kv_cache"]["sources"] == 1
    assert out["prom"].read_text() == r.metrics.expose_text()
    events = json.loads(out["trace"].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"tick", "decode", "guardrail", "prefill"} <= names
    assert [f["seam"] for f in r.fault_log] == ["nan_verify", "quant_corrupt"]
