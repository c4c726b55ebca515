"""A closed backlog: every slot busy, a queue kept at least ``depth`` deep.

Mix keys: ``slots``, ``depth``, ``prompt_len``, ``task``, ``new_tokens``.
Requests are made when the driver asks for them, as many as the run
needs, request ``i`` from ``(seed, i)`` alone.  The first ``slots`` are
the warm-up's: their budgets step evenly up to ``new_tokens`` so that the
slots finish at spread-out ticks and the window opens on requests at
every stage, as a long-running backlog has them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from traffic.prompts import prompt
from traffic.request import Request, Traffic


class Backlog:
    """The requests of one seed, made on demand and kept once made."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, int(seed) % (2 ** 63)
        self.made: Dict[int, Request] = {}

    def __getitem__(self, i: int) -> Request:
        if i not in self.made:
            m, slots = self.mix, self.mix["slots"]
            n_new = m["new_tokens"]
            budget = n_new if i >= slots else max(1, round(n_new * (i + 1) / slots))
            rng = np.random.default_rng((self.seed, i))
            self.made[i] = Request(prompt(rng, m["prompt_len"], self.vocab, m["task"]),
                                   budget, due=None, warm=i < slots)
        return self.made[i]


def make(mix: dict, vocab: int, seed: int, seconds: float) -> Traffic:
    return Traffic(kind="backlog", slots=mix["slots"], max_prompt_len=mix["prompt_len"],
                   max_new_tokens=mix["new_tokens"], requests=Backlog(mix, vocab, seed),
                   depth=mix["depth"])
