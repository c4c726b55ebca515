"""The window's least time by the roofline over its wall time: each decode
step at its live rows and contexts and each prefill at its prompt, the
larger of operations over peak and bytes over HBM rate, summed."""
from benchkit import counts


def read(run):
    steps, adm = run.part("window")
    if not steps:
        return None
    d = run.dims
    t = sum(counts.verify_step(d, run.window, live, ctx).least_s for _, live, _, ctx in steps)
    t += sum(counts.prefill(d, P - 1).least_s for _, P in adm)
    return 100.0 * t / (run.w1 - run.w0)
