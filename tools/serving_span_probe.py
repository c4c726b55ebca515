"""What one traced benchmark run shows by the program's own spans, beyond
the benchmark's result line: the serving tracer's sub-spans (host and
device times over the measured window), the host synchronisations a tick
by span and by call site, the idle time of the traced sub-window by
innermost sub-span, and how ``step.launch``'s device interval (CUDA events
on the tracer's clock) agrees with the profiler's kernels under it.

    python3 tools/serving_span_probe.py --seed 3000003021 --seconds 51 \\
        --out chiprun_out/probe.json                 # on the card
    python3 tools/serving_span_probe.py --seed 7 --seconds 2 --cpu-tiny 1 \\
        --out /tmp/probe.json                        # the tiny CPU cell

Runs one ``--trace 1`` run of a cell through ``bench/benchkit/cell.run``
and keeps what that run drops before its readers: the program's
``Tracer``, the ``Run`` the readers get and the profiler's raw events.  It
adds the sub-span names to the harness's ``SPANS`` for this process only,
so the idle breakdown goes to the innermost sub-span.  Writes everything
to ``--out`` as JSON and prints a summary and the run's result line.  On
the CPU (``--cpu-tiny 1``) there are no device times, syncs or kernels:
the run checks the plumbing.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH / ".cache" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
for i, p in enumerate((BENCH, ROOT / "src", ROOT)):
    sys.path.insert(i, str(p))

SUB_SPANS = ("append_blocks", "prefill.rows", "prefill.forward", "prefill.scatter",
             "prefill.drafter", "prefix.register", "step.prepare", "step.snapshot",
             "step.launch", "step.read", "step.guard", "stream")


def _median(v):
    return statistics.median(v) if v else None


def _spans(events):
    """(name, host t0, host t1, dev_t0, dev_t1) of every closed span, µs."""
    stack, out = defaultdict(list), []
    for e in events:
        if e["ph"] == "B":
            stack[e["tid"]].append(e)
        elif e["ph"] == "E":
            b = stack[e["tid"]].pop()
            a = e.get("args", {})
            out.append((e["name"], b["ts"], e["ts"], a.get("dev_t0"), a.get("dev_t1")))
    return out


def _clock_agreement(raw, spans, sub):
    """``step.launch`` in the traced sub-window: its event interval against
    the union of the kernels under the profiler's device-side annotation,
    and, step by step, the events' ends against the first and last kernel
    moved onto the tracer's clock by the two host clocks' offset."""
    from benchkit import stats

    kern = [(s, e) for n, cuda, ann, s, e in raw
            if cuda and not ann and not n.startswith(("Memcpy", "Memset"))]
    ann_dev = sorted((s, e) for n, cuda, ann, s, e in raw
                     if cuda and ann and n == "step.launch")
    ann_host = sorted((s, e) for n, cuda, ann, s, e in raw
                      if not cuda and n == "step.launch")
    ours = sorted((s[1], s[2], s[3], s[4]) for s in spans if s[0] == "step.launch"
                  and s[3] is not None and sub[0] <= s[1] < sub[1])
    pairs = []
    if len(ann_host) == len(ours) == len(ann_dev):
        for (hs, he), (ts, te, d0, d1), (gs, ge) in zip(ann_host, ours, ann_dev):
            ks = stats.clip(kern, gs, ge)
            if not ks:
                continue
            off = ts - hs
            pairs.append({"start_diff_ms": (d0 - min(a for a, _ in ks) - off) / 1e3,
                          "end_diff_ms": (d1 - max(b for _, b in ks) - off) / 1e3,
                          "host_clock_drift_ms": ((te - ts) - (he - hs)) / 1e3,
                          "interval_ms": (d1 - d0) / 1e3,
                          "union_ms": stats.covered(ks) / 1e3})
    return {"events_median_ms": _median([(d1 - d0) / 1e3 for _, _, d0, d1 in ours]),
            "union_median_ms": _median([stats.covered(stats.clip(kern, s, e)) / 1e3
                                        for s, e in ann_dev]),
            "n_events": len(ours), "n_annotations": len(ann_dev), "pairs": pairs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="paper7b-backlog-1k")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu-tiny", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from benchkit import cell, devtrace, program
    from benchkit.spec import Bench
    from tools.check_trace import validate

    kept = {"sites": [], "raw": []}
    make_tracer, reduce, make_run = program.tracer, devtrace.reduce, cell.Run

    def tracer():
        tr = kept["tracer"] = make_tracer()
        inner = warnings.showwarning

        def show(message, category, filename, lineno, *rest):
            # each synchronising call's site, by the span the tracer counts it in
            if str(message).startswith("called a synchronizing CUDA operation"):
                op = tr._syncs.open
                kept["sites"].append((time.perf_counter(),
                                      f"{os.path.relpath(filename, ROOT)}:{lineno}",
                                      op[-1] if op else "outside"))
            inner(message, category, filename, lineno, *rest)
        warnings.showwarning = show
        return tr

    def keep_raw(events, names):
        from torch.autograd import DeviceType
        kept["raw"] = [(e.name, e.device_type == DeviceType.CUDA,
                        bool(getattr(e, "is_user_annotation", False)),
                        e.time_range.start, e.time_range.end) for e in events]
        return reduce(events, names)

    def run_rec(**kw):
        r = kept["run"] = make_run(**kw)
        return r

    program.tracer, devtrace.reduce, cell.Run = tracer, keep_raw, run_rec
    cell.SPANS = tuple(cell.SPANS) + SUB_SPANS
    if a.cpu_tiny:
        import tempfile
        sys.path.insert(0, str(BENCH / "tests"))
        import tiny_cell
        root, name = tiny_cell.make(Path(tempfile.mkdtemp()))
        res = cell.run(Bench(root, root / "bench"), name, a.seed, a.seconds, True, "cpu",
                       T_START, drain_cap=5.0)
    else:
        res = cell.run(Bench(ROOT), a.workload, a.seed, a.seconds, True, "cuda", T_START)

    run, tr = kept["run"], kept["tracer"]
    w0, w1 = run.w0 * 1e6, run.w1 * 1e6
    exported = tr.export()
    spans = _spans(tr.events)
    inw = [s for s in spans if w0 <= s[1] < w1]
    ticks = sum(1 for s in inw if s[0] == "tick")
    names = sorted({s[0] for s in inw})
    host = {n: {"n": sum(1 for s in inw if s[0] == n),
                "median_ms": _median([(s[2] - s[1]) / 1e3 for s in inw if s[0] == n]),
                "total_s": sum(s[2] - s[1] for s in inw if s[0] == n) / 1e6} for n in names}
    dev = {}
    for n in names:
        d = [(s[4] - s[3]) / 1e3 for s in inw if s[0] == n and s[3] is not None]
        if d:
            dev[n] = {"n": len(d), "median_ms": _median(d), "total_s": sum(d) / 1e3}
    syncs = Counter()
    for e in tr.events:
        if e["ph"] == "C" and e["name"] == "host_syncs" and w0 <= e["ts"] < w1:
            syncs.update(e["args"])
    prefills = host.get("prefill", {}).get("n", 0)
    sites = Counter((site, sp) for t, site, sp in kept["sites"] if run.w0 <= t < run.w1)
    sub = (run.trace_span[0] * 1e6, run.trace_span[1] * 1e6)

    out = {
        "seed": a.seed, "seconds": a.seconds, "result": res,
        "check_trace": validate(exported)[:10],
        "dropped_events": exported["otherData"]["dropped_events"],
        "ticks": ticks, "prefills": prefills,
        "prefill_ms_window": host.get("prefill", {}).get("median_ms"),
        "syncs_per_tick": sum(syncs.values()) / ticks if ticks else None,
        "syncs_by_span_per_tick": ({k: v / ticks for k, v in syncs.most_common()}
                                   if ticks else None),
        "sync_sites_per_tick": ([[s, sp, n / ticks] for (s, sp), n in sites.most_common(40)]
                                if ticks else None),
        "step_device_ms": dev.get("step.launch", {}).get("median_ms"),
        "host_ms": host, "device_ms": dev,
        "clock": _clock_agreement(kept["raw"], spans, sub),
        "idle_by_span": run.trace.idle_by_span(40) if run.trace else None,
    }
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({k: out[k] for k in ("check_trace", "dropped_events", "ticks", "prefills",
                                          "prefill_ms_window", "syncs_per_tick",
                                          "step_device_ms")}, default=str))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
