"""The window's wall time over its decode ticks (one step each)."""


def read(run):
    n = sum(1 for s in run.steps if run.w0 <= s[0] < run.w1)
    return 1e3 * (run.w1 - run.w0) / n if n else None
