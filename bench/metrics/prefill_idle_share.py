"""Share of the program's ``prefill`` spans' time in the traced sub-window
with no kernel running on the device; nothing to read where the trace holds
no kernel (no card).  A profiled reading: ``torch.profiler`` records every
operation of the eager prefill, which lengthens its host time, so the share
is higher than the same admissions leave idle outside the profiler."""
from benchkit import stats


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    kernels = [(a, b) for _, a, b in run.trace.kernels]
    total = idle = 0.0
    for name, a, b in run.trace.spans:
        if name == "prefill":
            total += b - a
            idle += (b - a) - stats.covered(stats.clip(kernels, a, b))
    return 100.0 * idle / total if total > 0 else None
