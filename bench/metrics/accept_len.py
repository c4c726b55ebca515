"""Committed tokens per live row per decode step in the window (the
AcceptanceStats counts each step reports)."""


def read(run):
    steps = [s for s in run.steps if run.w0 <= s[0] < run.w1]
    rows = sum(s[1] for s in steps)
    return sum(s[2] for s in steps) / rows if rows else None
