"""95th percentile (nearest rank) over the requests finished in the window
of (last token - first token) / (tokens - 1)."""
from benchkit import stats


def read(run):
    v = [stats.tpot(r["first"], r["last"], r["tokens"]) for r in run.requests.values()
         if r["finish"] is not None and run.w0 <= r["finish"] < run.w1 and not r["warm"]]
    p = stats.percentile([x for x in v if x is not None], 95)
    return None if p is None else 1e3 * p
