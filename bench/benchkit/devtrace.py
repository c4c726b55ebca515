"""The traced sub-window: ``torch.profiler`` over some served ticks, reduced
to the device's kernel intervals and the host spans around them.

Busy time is the union of the kernels' intervals (copies and fills are not
kernels and not counted), clipped to the sub-window; idle time is the rest
of the sub-window, and each idle gap is put to the innermost host span
(``tick``, ``admit``, ``prefill``, ``decode``, ``harvest``, …: the program's
``Tracer`` spans, on the timeline through ``annotate_device``) that holds
its midpoint, or to ``outside`` where none does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from benchkit import stats

WINDOW = "bench_traced_window"


@dataclasses.dataclass
class DeviceTrace:
    t0: float                                   # µs, the profiler's time base
    t1: float
    kernels: List[Tuple[str, float, float]]     # (name, start, end), clipped
    spans: List[Tuple[str, float, float]]       # host annotations

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return stats.covered((a, b) for _, a, b in self.kernels) / 1e6

    def family_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds any of
        ``patterns`` (the union of their intervals)."""
        return stats.covered((a, b) for n, a, b in self.kernels
                             if any(p in n for p in patterns)) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.kernels:
            key = _short(name)
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle seconds summed by the innermost host span at each gap."""
        by: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda s: s[1])
        for a, b in stats.gaps([(x, y) for _, x, y in self.kernels], self.t0, self.t1):
            mid, inner = (a + b) / 2, None
            for name, s0, s1 in spans:
                if s0 > mid:
                    break
                if s1 >= mid:
                    inner = name          # the latest-starting span holding mid
            key = inner or "outside"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and signature."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return (n.split("(")[0].split("<")[0].strip() or name)[:90]


def profile(run: Callable[[], None], span_names: Sequence[str]) -> DeviceTrace:
    """Run ``run`` under ``torch.profiler`` (CPU and CUDA activity) and
    reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        with record_function(WINDOW):
            run()
            if card:
                torch.cuda.synchronize()
    return reduce(prof.events(), span_names)


def reduce(events, span_names: Sequence[str]) -> DeviceTrace:
    """Kernel intervals and host spans of a profiler's events."""
    from torch.autograd import DeviceType

    names = set(span_names) | {WINDOW}
    t0 = t1 = None
    kernels, spans = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                t0, t1 = a, b
            elif e.name in names:
                spans.append((e.name, a, b))
        elif e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in names \
                    or e.name.startswith(("Memcpy", "Memset")):
                continue
            kernels.append((e.name, a, b))
    if t0 is None:
        raise RuntimeError("the traced window's annotation is missing from the trace")
    return DeviceTrace(t0, t1, stats.clip_named(kernels, t0, t1), spans)


def summary(trace: Optional[DeviceTrace]) -> Optional[dict]:
    if trace is None:
        return None
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_by_span()}
