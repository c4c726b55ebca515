"""An open loop of Poisson arrivals at a fixed rate.

Mix keys: ``slots``, ``rate`` (requests/s), ``prompt_len`` and
``new_tokens`` ([lo, hi], log-uniform), ``tasks`` (repetition presets,
taken in turn), ``warm_s`` (arrivals before the window opens), ``tail_s``
(arrivals made past the window, for the wait on its last requests) and
``shape_seed``.  The gaps and the sizes, in their order, come from
``shape_seed``, so every run seed offers the same work at the same times;
the run seed draws the prompts' tokens.
"""
from __future__ import annotations

import math

import numpy as np

from traffic.prompts import prompt
from traffic.request import Request, Traffic


def _log_uniform(rng, lo: int, hi: int, n: int) -> np.ndarray:
    return np.exp(rng.uniform(math.log(lo), math.log(hi + 1), n)).astype(np.int64).clip(lo, hi)


def make(mix: dict, vocab: int, seed: int, seconds: float) -> Traffic:
    rate = float(mix["rate"])
    n = int(math.ceil(rate * (mix["warm_s"] + seconds + mix["tail_s"])))
    shape = np.random.default_rng(mix["shape_seed"])
    due = np.cumsum(shape.exponential(1.0 / rate, n)) - mix["warm_s"]   # window opens at 0
    plen = _log_uniform(shape, *mix["prompt_len"], n)
    nnew = _log_uniform(shape, *mix["new_tokens"], n)
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    tasks = mix["tasks"]
    reqs = [Request(prompt(rng, int(plen[i]), vocab, tasks[i % len(tasks)]), int(nnew[i]),
                    due=float(due[i]), warm=bool(due[i] < 0)) for i in range(n)]
    return Traffic(kind="poisson", slots=mix["slots"], max_prompt_len=mix["prompt_len"][1],
                   max_new_tokens=mix["new_tokens"][1], requests=reqs)
