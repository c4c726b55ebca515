"""Committed output tokens streamed in the window, over its wall time."""


def read(run):
    n = sum(k for v in run.requests.values() for t, k in v["emits"] if run.w0 <= t < run.w1)
    return n / (run.w1 - run.w0) if n else None
