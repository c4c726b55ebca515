"""One run of one cell: set-up, warm-up, the measured window, the wait for
the window's last answers, the traced sub-window (``--trace 1``), the
comparison that decides ``correct``, and the readers.

The served entry is ``repro_torch``'s ``ServingLoop`` (``submit`` / ``poll``
on this thread, the real clock, FIFO admission, no deadlines, no shedding,
no faults).  A backlog mix keeps every slot busy and a queue ``depth``
deep; an open-loop mix submits each request when it is due and times it
from then, and the generator's lateness goes to standard error.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchkit import correct, counts, devtrace, program, weights
from benchkit.spec import Bench

SPANS = ("tick", "admit", "prefill", "decode", "harvest", "preempt", "swap_out", "swap_in",
         "guardrail")
TRACE_S = 1.5          # the traced sub-window's length (s)
DRAIN_CAP_S = 60.0     # the longest wait past the window for its last answers


@dataclasses.dataclass
class Run:
    """What the readers read (``bench/metrics/<name>.py``'s ``read(run)``)."""

    kind: str
    seconds: float
    w0: float
    w1: float
    setup_s: float
    window: int                        # verify window, gamma + 1
    dims: counts.Dims
    requests: Dict[int, dict]          # rid -> due, admit, first, last, tokens, finish, ...
    steps: List[tuple]                 # (t, live rows, committed, context sum)
    admissions: List[tuple]            # (t, rid)
    trace: Optional[devtrace.DeviceTrace] = None
    trace_span: tuple = (0.0, 0.0)     # host clock bounds of the traced sub-window
    bench: Optional[Bench] = None

    def part(self, name: str):
        """(steps, admissions with prompt lengths) of the measured window
        (``"window"``) or of the traced sub-window (``"trace"``)."""
        lo, hi = (self.w0, self.w1) if name == "window" else self.trace_span
        steps = [s for s in self.steps if lo <= s[0] < hi]
        adm = [(t, self.requests[r]["P"]) for t, r in self.admissions if lo <= t < hi]
        return steps, adm

    def family_work(self, family: str, part: str = "trace") -> Optional[counts.Work]:
        spec = self.bench.families()[family]
        return self.bench.count_fn(spec["count"])(self, *self.part(part))

    def family_roofline(self, family: str) -> Optional[float]:
        if self.trace is None:
            return None
        t = self.trace.family_s(self.bench.families()[family]["kernels"])
        work = self.family_work(family)
        if t <= 0 or work is None:
            return None
        return counts.share(work, t)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(bench: Bench, cell: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, control: bool = False, drain_cap: float = DRAIN_CAP_S) -> dict:
    """One run; returns the result line's object.  ``drain_cap`` bounds the
    backlog's warm-up too: a warm-up whose requests never finish ends there
    and the run goes on, to be judged."""
    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    mix = bench.mix(wl["traffic"])
    model = cfg["model"]
    dev = torch.device(device)
    clock = time.perf_counter

    marks = [("start", t_start)]
    if dev.type == "cuda":
        program.build_kernels()
        torch.cuda.init()
    marks.append(("kernels built, card up", clock()))
    traffic = bench.generator(mix["kind"])(mix, model["vocab_size"], seed, seconds)
    marks.append(("traffic", clock()))
    ref = bench.reference(cfg)
    raw = weights.make(ref.layout(model), seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("weights", clock()))
    mcfg = program.model_config(cfg)
    params = program.program_params(mcfg, raw)
    eng = program.engine(mcfg, cfg, dev)
    recs = program.Records()
    tracer = program.tracer() if trace else None
    loop = program.serving_loop(eng, params, traffic, program.recorder(recs, clock), tracer)
    gamma = cfg["engine"]["gamma"]

    t_built = clock()
    info: Dict[int, dict] = {}
    handles: Dict[int, object] = {}
    reqs = traffic.requests
    state = {"next": 0, "late": []}

    def submit(i: int, due: Optional[float]):
        r = reqs[i]
        h = loop.submit(program.generation_request(r, seed=i))
        now = clock()
        recs.prompt_len[h.rid] = len(r.prompt)
        info[h.rid] = dict(i=i, due=now if due is None else due, submit=now, warm=r.warm,
                           P=len(r.prompt), new=r.new_tokens)
        handles[h.rid] = h
        if due is not None:
            state["late"].append(now - due)

    def outstanding() -> int:
        return sum(1 for rid in info if rid not in recs.finish and rid not in recs.failed)

    def queued() -> int:
        return outstanding() - sum(1 for r in info if r in recs.admit
                                   and r not in recs.finish and r not in recs.failed)

    if traffic.kind == "backlog":
        def serve_once():
            while outstanding() < traffic.slots + traffic.depth:
                submit(state["next"], None)
                state["next"] += 1
            loop.poll()
        serve_once()
        warm = [rid for rid, v in info.items() if v["warm"]]
        t_cap = clock() + drain_cap
        while not all(r in recs.finish or r in recs.failed for r in warm) and clock() < t_cap:
            serve_once()
        w0 = clock()
    else:
        T0 = clock() + mix["warm_s"]

        def serve_once():
            now = clock()
            while state["next"] < len(reqs) and T0 + reqs[state["next"]].due <= now:
                submit(state["next"], T0 + reqs[state["next"]].due)
                state["next"] += 1
            if not loop.poll():
                nxt = (T0 + reqs[state["next"]].due if state["next"] < len(reqs)
                       else now + 1e-3)
                time.sleep(max(0.0, min(1e-3, nxt - clock())))
        while clock() < T0:
            serve_once()
        w0 = T0
    w1 = w0 + seconds
    setup_s = w0 - t_start
    marks += [("engine", t_built), ("warm-up", w0)]
    log(f"set-up {setup_s:.2f} s: " + ", ".join(
        f"{n} {b - a:.2f}" for (_, a), (n, b) in zip(marks, marks[1:])))
    queue_w0 = queued()
    while clock() < w1:
        serve_once()
    queue_w1 = queued()
    log(f"window: {sum(1 for s in recs.steps if w0 <= s[0] < w1)} ticks, "
        f"{sum(1 for t, _ in recs.admissions if w0 <= t < w1)} admissions; "
        f"queue {queue_w0} at the opening, {queue_w1} at the close")

    # the wait for the window's last answers
    running = [r for r, v in info.items() if r in recs.admit and recs.admit[r] < w0
               and not (r in recs.finish and recs.finish[r] < w0)]
    due_in = ([r for r, v in info.items() if w0 <= v["due"] < w1]
              if traffic.kind != "backlog" else [])

    def waiting():
        return ([r for r in running if r not in recs.finish and r not in recs.failed]
                + [r for r in due_in if r not in recs.emits and r not in recs.failed])
    t_cap = clock() + drain_cap
    while waiting() and clock() < t_cap:
        serve_once()
    unanswered = len(waiting())

    dtrace, span = None, (0.0, 0.0)
    if trace:
        box = {}

        def sub():
            box["t0"] = clock()
            while clock() < box["t0"] + TRACE_S:
                serve_once()
            box["t1"] = clock()
        t_tr = clock()
        dtrace = devtrace.profile(sub, SPANS)
        span = (box["t0"], box["t1"])
        log(f"traced sub-window {box['t1'] - box['t0']:.2f} s, with the trace's reduction "
            f"{clock() - t_tr:.1f} s, {len(dtrace.kernels)} kernels")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    done = [dict(prompt=reqs[info[r]["i"]].prompt, served=handles[r].collected())
            for r in sorted(recs.finish) if not info[r]["warm"]]
    failed = len(recs.failed)
    requests = _requests(info, recs)
    if tracer is not None:
        # the program's "admit" span opens before the prefill; on_admit
        # fires after it
        for ev in tracer.events:
            if ev["ph"] == "B" and ev["name"] == "admit":
                r = requests.get(ev.get("args", {}).get("rid"))
                if r is not None and r.get("admit_start") is None:
                    r["admit_start"] = ev["ts"] / 1e6
    attempted = sum(1 for r, v in requests.items()
                    if not v["warm"] and ((w0 <= v["due"] < w1) if traffic.kind != "backlog"
                                          else v["admit"] is not None and v["admit"] < w1
                                          and (v["finish"] is None or v["finish"] >= w0)))
    steps, admissions = list(recs.steps), list(recs.admissions)
    late = state["late"]
    del loop, eng, params, handles, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, after the window, on the raw weights alone
    t_ref = clock()
    picked = correct.sample(done, seed)
    ref_logits, gap = correct.served_gaps(ref, model, raw, picked, dev)
    checks = correct.checks(gap, cfg["correct"]["logit_gap"], unanswered, failed)
    ok = correct.passed(checks)
    log(f"reference: {len(picked)} requests, {gap.size} served tokens, "
        f"{clock() - t_ref:.1f} s")
    out_control = None
    if control:
        out_control = _control(mcfg, cfg, raw, picked, ref_logits, dev)
    del ref_logits

    run_rec = Run(kind=traffic.kind, seconds=seconds, w0=w0, w1=w1, setup_s=setup_s,
                  window=gamma + 1, dims=counts.Dims.of(model), requests=requests,
                  steps=steps, admissions=admissions,
                  trace=dtrace, trace_span=span, bench=bench)
    metrics = {}
    for m in (bench.per_layer(cell) if trace else bench.end_to_end(cell)):
        v = bench.reader(m["name"])(run_rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if late:
        log(f"generator lateness: mean {1e3 * float(np.mean(late)):.3f} ms, "
            f"max {1e3 * float(np.max(late)):.3f} ms over {len(late)} arrivals")
    result = {
        "correct": bool(ok), "attempted": int(attempted), "failed": int(failed + unanswered),
        "metrics": metrics,
        "device": _device(dev, peak),
    }
    if dtrace is not None:
        result["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        result["breakdown"] = devtrace.summary(dtrace)
    if out_control is not None:
        result["control"] = out_control
        result["served_gaps"] = _gap_stats(gap)
    result["checks"] = checks
    log(f"process {clock() - t_start:.1f} s")
    return result


def _requests(info, recs) -> Dict[int, dict]:
    out = {}
    for rid, v in info.items():
        em = recs.emits.get(rid, [])
        out[rid] = dict(v, admit=recs.admit.get(rid), admit_start=None,
                        first=em[0][0] if em else None, last=em[-1][0] if em else None,
                        tokens=sum(n for _, n in em), emits=em,
                        finish=recs.finish.get(rid), failed=rid in recs.failed)
    return out


def _device(dev, peak) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _gap_stats(gap: np.ndarray) -> dict:
    return {"max": float(gap.max()), "p99": float(np.quantile(gap, 0.99)),
            "n": int(gap.size)}


def _control(mcfg, cfg, raw, picked, ref_logits, dev) -> dict:
    """The program's W4A8 verifier in the W8A8 one's place: its full
    forward over the sampled prompts and served tokens, the reference's gap
    of the token it puts first at each position."""
    eng = program.engine(mcfg, cfg, dev, verifier="w4a8")
    params = program.program_params(mcfg, raw)
    prepared = eng.prepare_params(params)
    seqs, starts = correct.sequences(picked, dev)
    ctrl = []
    with torch.inference_mode():
        for s, st in zip(seqs, starts):
            lg, _ = eng.model.forward(prepared, s[None])
            ctrl.append(lg[0, st:-1].float())
    del prepared, params, eng
    g = correct.control_gaps(ref_logits, ctrl)
    return _gap_stats(g)
