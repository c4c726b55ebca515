"""Synthetic prompts with a task's repetition preset — a copy of
``repro_torch/data/synthetic.py``'s ``task_prompts`` (``synthetic_corpus``
over the seeded Markov chain), with the Zipf draw taken from a cumulative
table built once instead of ``Generator.choice`` per token.

With probability ``repeat_prob`` per position a segment copied from
earlier in the prompt continues (geometric length, mean 8): the structure
prompt-lookup drafting feeds on.  Fresh tokens follow the chain's four
likely successors with probability ``markov_alpha``, else a Zipf marginal.
"""
from __future__ import annotations

import functools

import numpy as np

TASK_REPETITION = {"mtbench": 0.30, "humaneval": 0.55, "gsm8k": 0.60,
                   "alpaca": 0.25, "cnndm": 0.35}
N_SUCC = 4
MEAN_COPY = 8
MARKOV_ALPHA = 0.97


@functools.lru_cache(maxsize=4)
def succ_table(vocab: int, data_seed: int = 0) -> np.ndarray:
    """The chain's successor table, (vocab, 4), from ``data_seed``."""
    return np.random.default_rng(data_seed).integers(0, vocab, size=(vocab, N_SUCC))


@functools.lru_cache(maxsize=4)
def zipf_cdf(vocab: int) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    c = np.cumsum(p / p.sum())
    return c / c[-1]


def prompt(rng: np.random.Generator, length: int, vocab: int, task: str) -> np.ndarray:
    """One (length,) int32 prompt of ``task``'s repetition preset."""
    rep = TASK_REPETITION[task]
    succ, cdf = succ_table(vocab), zipf_cdf(vocab)
    out = np.empty(length, np.int32)
    i = 0
    while i < length:
        if i > 16 and rng.random() < rep:
            src = int(rng.integers(0, i - 8))
            n = min(1 + int(rng.geometric(1.0 / MEAN_COPY)), length - i, i - src)
            out[i:i + n] = out[src:src + n]
            i += n
        else:
            if i > 0 and rng.random() < MARKOV_ALPHA:
                out[i] = succ[out[i - 1], rng.integers(0, N_SUCC)]
            else:
                out[i] = min(int(cdf.searchsorted(rng.random(), side="right")), vocab - 1)
            i += 1
    return out
