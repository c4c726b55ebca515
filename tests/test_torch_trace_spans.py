"""The port's tracer inside the serving path (``repro_torch/serving/trace.py``)
on a tiny paged ``ServingLoop`` on the CPU: the sub-spans of an admission
and of a tick nest where the work happens, device times land on the
tracer's clock (CUDA events stubbed by host-clock ones), the count of
synchronising CUDA calls goes to the innermost open span, and the off path
(``NULL_TRACER``) installs and records nothing."""
import gc
import itertools
import json
import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.models import Model
from repro_torch.serving import trace
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.metrics import ServerMetrics
from repro_torch.serving.request import GenerationRequest
from repro_torch.serving.server import ServerConfig, ServingLoop
from repro_torch.serving.trace import DEVICE_TRACK, NULL_TRACER, SYNC_WARNING, Tracer
from test_torch_batching import one_torch_thread  # noqa: F401
from tools.check_trace import validate

TIMED = {"prefill", "prefill.rows", "prefill.forward", "prefill.scatter", "prefill.drafter",
         "step.prepare", "step.launch", "step.read"}
PARENT = {"prefill.rows": "prefill", "prefill.forward": "prefill",
          "prefill.scatter": "prefill", "prefill.drafter": "prefill",
          "prefill": "admit", "prefix.register": "admit", "admit": "tick",
          "step.prepare": "decode", "append_blocks": "step.prepare",
          "step.snapshot": "decode", "step.launch": "decode", "step.read": "decode",
          "step.guard": "decode", "decode": "tick", "stream": "tick", "harvest": "tick"}


class FakeEvent:
    """A CUDA timing event stand-in: completes when recorded, at the time of
    a shared counter clock (ms, as ``elapsed_time`` returns)."""

    clock = None

    def record(self):
        self.t = FakeEvent.clock()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def stub_events(monkeypatch):
    ticks = itertools.count()
    FakeEvent.clock = lambda: next(ticks) * 1e-6
    monkeypatch.setattr(trace, "_cuda_timing", lambda: (FakeEvent, lambda: False))
    yield FakeEvent.clock
    gc.collect()                          # the tracers' counters leave the sync hook


def _model():
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(0))


def _requests(V):
    rng = np.random.default_rng(3)
    pat = rng.integers(0, V, 6)
    return [GenerationRequest(np.tile(pat, k), max_new_tokens=n, seed=s)
            for k, n, s in ((4, 8, 11), (3, 6, 22), (2, 9, 33), (4, 5, 44))]


def serve(tracer=None, clock=None, metrics=None):
    """Four requests through two paged slots (prefix sharing on, so the
    repeated pattern hits the index); the served tokens, the loop."""
    model, params = _model()
    eng = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, kv_layout="paged",
                                       kv_block_size=8), drafter="ngram", verifier="w8a8")
    kw = {} if clock is None else {"clock": clock}
    loop = ServingLoop(eng, params, ServerConfig(batch_slots=2, max_prompt_len=32,
                                                 max_new_tokens=12),
                       tracer=tracer, metrics=metrics, **kw)
    handles = [loop.submit(r) for r in _requests(model.cfg.vocab_size)]
    loop.drain(max_polls=200)
    assert all(h.status == "done" for h in handles)
    return [h.result(0.0).tokens.tolist() for h in handles], loop


def _parents(events):
    """(name, parent name) of every duration span, per track."""
    stacks, out = {}, []
    for ev in events:
        if ev["ph"] == "B":
            st = stacks.setdefault(ev["tid"], [])
            out.append((ev["name"], st[-1] if st else None))
            st.append(ev["name"])
        elif ev["ph"] == "E":
            stacks[ev["tid"]].pop()
    return out


def test_sub_spans_nest_and_the_export_has_a_device_track(stub_events):
    tr = Tracer(clock=stub_events, annotate_device=True)
    serve(tr)
    exported = tr.export()
    assert validate(exported) == []
    assert validate(json.loads(tr.dumps())) == []
    events = exported["traceEvents"]
    pairs = _parents(events)
    names = {n for n, _ in pairs}
    assert set(PARENT) <= names
    for name, parent in pairs:
        if name in PARENT:
            assert parent == PARENT[name], (name, parent)
    # the device spans' ends carry their device times; no other span's does
    ends = [ev for ev in events if ev["ph"] == "E" and ev["tid"] < DEVICE_TRACK]
    timed = [ev for ev in ends if "dev_t0" in ev.get("args", {})]
    assert {ev["name"] for ev in timed} == TIMED
    assert all(ev["args"]["dev_t0"] <= ev["args"]["dev_t1"] for ev in timed)
    assert len(timed) == sum(1 for ev in ends if ev["name"] in TIMED)
    # one device track for the lane: a complete event per device span, by start
    xs = [ev for ev in events if ev["ph"] == "X"]
    assert {ev["tid"] for ev in xs} == {DEVICE_TRACK}
    assert len(xs) == len(timed)
    assert [ev["ts"] for ev in xs] == sorted(ev["ts"] for ev in xs)
    assert all(ev["dur"] >= 0 for ev in xs)
    label = [ev for ev in events if ev["ph"] == "M" and ev["tid"] == DEVICE_TRACK]
    assert len(label) == 1 and label[0]["args"]["name"].endswith(" device")
    # the prefill's args: its prompt and padded lengths
    b = next(ev for ev in events if ev["ph"] == "B" and ev["name"] == "prefill")
    assert b["args"]["pmax"] == 32 and 0 < b["args"]["P"] <= 32
    assert exported["otherData"]["dropped_events"] == 0


def test_tokens_are_identical_with_device_tracing_on_and_off(stub_events):
    off, _ = serve()
    on, _ = serve(Tracer(clock=stub_events, annotate_device=True))
    assert on == off


def test_device_times_resolve_against_the_nearest_anchor(monkeypatch):
    """Events older than any anchor resolve against the first one after
    them, later ones against the last one before them; an event not yet
    complete waits for a later pass; none is recorded while capturing."""
    host = [0.0]
    done = {"ok": False}
    capturing = {"on": False}

    class Ev:
        def record(self):
            self.t = host[0] + 5e-6        # the card runs 5 µs behind the host

        def query(self):
            return done["ok"]

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(trace, "_cuda_timing", lambda: (Ev, lambda: capturing["on"]))
    tr = Tracer(clock=lambda: host[0], annotate_device=True)
    with tr.span("step.launch", device=True):
        host[0] = 1e-3
    host[0] = 2e-3
    tr.anchor()                           # the card is idle here: event at host + 5 µs
    host[0] = 3e-3
    with tr.span("step.read", device=True):
        host[0] = 4e-3
    with tr.span("step.snapshot"):
        pass
    capturing["on"] = True
    with tr.span("prefill", device=True):
        pass
    capturing["on"] = False
    tr.tick_end()
    assert all("dev_t0" not in ev.get("args", {}) for ev in tr.events)
    done["ok"] = True
    tr.tick_end()
    got = {ev["name"]: (ev["args"]["dev_t0"], ev["args"]["dev_t1"])
           for ev in tr.events if ev["ph"] == "E" and "dev_t0" in ev.get("args", {})}
    assert set(got) == {"step.launch", "step.read"}
    # device times on the host clock, shifted by the anchor's own lag
    assert got["step.launch"] == pytest.approx((0.0, 1000.0))
    assert got["step.read"] == pytest.approx((3000.0, 4000.0))
    assert validate(tr.export()) == []


def test_sync_count_takes_every_call_to_the_innermost_span():
    """Fed through the warnings machinery, as torch's sync debug mode
    feeds it: repeated calls at one site all count, each by the innermost
    open span; other warnings pass on; ``tick_end`` emits and resets."""
    gc.collect()
    assert not trace._SYNC_HOOK.counters
    tr = Tracer(clock=itertools.count().__next__, annotate_device=True)
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("default")
        warnings.showwarning = lambda m, *a, **k: seen.append(str(m))
        filters = list(warnings.filters)
        trace._SYNC_HOOK.add(tr._syncs)
        with tr.span("tick"):
            with tr.span("prefill"):
                with tr.span("prefill.scatter"):
                    for _ in range(3):
                        warnings.warn(f"{SYNC_WARNING} (Triggered internally)")
                warnings.warn(f"{SYNC_WARNING} (Triggered internally)")
            warnings.warn("an unrelated warning")
        warnings.warn(f"{SYNC_WARNING} (Triggered internally)")
        tr.tick_end(0)
        trace._SYNC_HOOK.remove(tr._syncs)
        assert warnings.filters == filters
    assert seen == ["an unrelated warning"]
    counters = [ev for ev in tr.events if ev["ph"] == "C"]
    assert len(counters) == 1 and counters[0]["name"] == "host_syncs"
    assert counters[0]["args"] == {"prefill.scatter": 3.0, "prefill": 1.0, "outside": 1.0}
    tr.tick_end(0)                        # nothing counted since: no counter
    assert sum(ev["ph"] == "C" for ev in tr.events) == 1


def _sync():
    warnings.warn(f"{SYNC_WARNING} (Triggered internally)")


def test_sync_count_outlives_an_earlier_tracer_and_keeps_to_its_thread():
    """Two counting tracers alive at once: the hook stays until the last
    one goes, so the second still counts after the first is removed; a call
    made on another thread than the tracer's own, inside or outside a span
    opened there, is not counted."""
    gc.collect()
    assert not trace._SYNC_HOOK.counters
    a = Tracer(clock=itertools.count().__next__, annotate_device=True)
    b = Tracer(clock=itertools.count().__next__, annotate_device=True)
    with warnings.catch_warnings():
        warnings.simplefilter("default")
        show = warnings.showwarning = lambda *a, **k: None
        filters = list(warnings.filters)
        trace._SYNC_HOOK.add(a._syncs)
        trace._SYNC_HOOK.add(b._syncs)
        with a.span("prefill"), b.span("decode"):
            _sync()
            trace._SYNC_HOOK.remove(a._syncs)
            assert warnings.showwarning == trace._SYNC_HOOK.showwarning
            _sync()
            other = threading.Thread(target=_sync)
            other.start()
            other.join()

            def spans_there():
                with b.span("stream"):
                    _sync()
            other = threading.Thread(target=spans_there)
            other.start()
            other.join()
            _sync()
        trace._SYNC_HOOK.remove(b._syncs)
        assert warnings.filters == filters and warnings.showwarning is show
    a.tick_end(0)
    b.tick_end(0)
    got = {tr: ev["args"] for tr in ("a", "b")
           for ev in (a if tr == "a" else b).events if ev["ph"] == "C"}
    assert got == {"a": {"prefill": 1.0}, "b": {"decode": 3.0}}


def test_the_off_path_installs_and_records_nothing(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("the off path touched CUDA timing")

    monkeypatch.setattr(trace, "_cuda_timing", no_cuda)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    filters, show = list(warnings.filters), warnings.showwarning
    off, loop = serve()
    assert loop.tracer is NULL_TRACER
    assert warnings.filters == filters and warnings.showwarning is show
    # a tracer without device annotation records spans and nothing else
    tr = Tracer(clock=itertools.count().__next__)
    assert serve(tr)[0] == off
    assert warnings.filters == filters and warnings.showwarning is show
    assert not any(ev["ph"] in ("X", "C") and ev["name"] not in ("occupancy", "free_blocks")
                   for ev in tr.export()["traceEvents"])
    assert all("dev_t0" not in ev.get("args", {}) for ev in tr.events)


def test_on_admit_is_stamped_before_the_prefill():
    ticks = itertools.count()

    def clock():
        return next(ticks) * 1e-3

    tr = Tracer(clock=clock)
    _, loop = serve(tr, clock=clock, metrics=ServerMetrics(keep_timelines=True))
    starts = sorted(ev["ts"] / 1e6 for ev in tr.events
                    if ev["ph"] == "B" and ev["name"] == "prefill")
    admits = sorted(tl.admit_t for tl in loop.metrics.timelines.values())
    assert len(starts) == len(admits) == 4
    # each admission's stamp falls between the previous prefill and its own
    for k, (a, p) in enumerate(zip(admits, starts)):
        assert a < p and (k == 0 or starts[k - 1] < a)
