"""Synthetic data pipeline — a copy of the host-side (numpy) helpers of
``repro/data/synthetic.py`` (``task_prompts``, ``ambiguous_prompts``,
``lm_batches`` and what they use), kept in the port so that it never
imports ``repro``.

Two needs:

* **training** — a learnable token stream (Zipf marginals + first-order
  Markov structure) so the end-to-end train example shows a falling loss;
* **serving / paper tables** — corpora with controllable *repetition*,
  because prompt-lookup drafting lives off n-gram reuse.  Each paper task
  gets a repetition preset chosen to mirror its qualitative behaviour
  (code/math >> open-ended chat), so Table-1-style orderings reproduce.

Serve prompts share the training Markov chain (same ``data_seed`` →
same successor table), so a trained stand-in model assigns realistic
probability to in-distribution continuations — that is what makes T>0
acceptance behave like the paper's real-LLM setting.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

# copy-probability presets per paper benchmark task (§4.1)
TASK_REPETITION: Dict[str, float] = {
    "mtbench": 0.30,
    "humaneval": 0.55,
    "gsm8k": 0.60,
    "alpaca": 0.25,
    "cnndm": 0.35,
}

N_SUCC = 4  # likely successors per token in the Markov chain


def succ_table(vocab: int, data_seed: int = 0) -> np.ndarray:
    """The Markov-chain successor table — FIRST draw from the seeded rng so
    ``lm_batches`` and ``task_prompts`` agree on the chain."""
    return np.random.default_rng(data_seed).integers(0, vocab, size=(vocab, N_SUCC))


def synthetic_corpus(
    rng: np.random.Generator,
    length: int,
    vocab: int,
    repeat_prob: float = 0.3,
    mean_copy_len: int = 8,
    markov: Optional[Tuple[np.ndarray, float]] = None,  # (succ, alpha)
) -> np.ndarray:
    """Token stream where, with probability ``repeat_prob`` per position, a
    segment copied from earlier in the stream continues (geometric length)
    — exactly the structure prompt-lookup decoding exploits.  Fresh tokens
    follow the Markov chain when given, else a Zipf marginal."""
    out = np.empty(length, np.int32)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    i = 0
    while i < length:
        if i > 16 and rng.random() < repeat_prob:
            src = int(rng.integers(0, i - 8))
            n = min(1 + rng.geometric(1.0 / mean_copy_len), length - i, i - src)
            out[i : i + n] = out[src : src + n]
            i += n
        else:
            if markov is not None and i > 0 and rng.random() < markov[1]:
                out[i] = markov[0][out[i - 1], rng.integers(0, N_SUCC)]
            else:
                out[i] = rng.choice(vocab, p=probs)
            i += 1
    return out


def task_prompts(
    task: str,
    batch: int,
    prompt_len: int,
    vocab: int,
    seed: int = 0,
    data_seed: int = 0,
    markov_alpha: float = 0.97,
) -> np.ndarray:
    """(B, P) int32 prompts with the task's repetition preset, drawn from
    the same Markov chain the stand-in models train on."""
    rep = TASK_REPETITION.get(task, 0.3)
    # crc32, NOT hash(): str hashing is salted per process, which made
    # "identical" benchmark prompts differ run to run
    rng = np.random.default_rng(seed + zlib.crc32(task.encode()) % 2**31)
    succ = succ_table(vocab, data_seed)
    return np.stack([
        synthetic_corpus(rng, prompt_len, vocab, rep,
                         markov=(succ, markov_alpha))
        for _ in range(batch)
    ])


def ambiguous_prompts(
    batch: int,
    prompt_len: int,
    vocab: int,
    depth: int = 4,
    seed: int = 0,
    data_seed: int = 0,
) -> np.ndarray:
    """Repetition workload with *ambiguous* trailing-gram continuations —
    the case tree drafting exists for.

    Each row ends in an anchor bigram ``(a, b)`` whose earlier
    occurrences continue differently: the older copies each follow one of
    the Markov chain's likely successors of ``b`` (the distribution the
    stand-in models are trained on), while the **most recent** copy
    continues with junk.  Chain prompt-lookup must propose the junk
    continuation (most-recent-match rule) and get rejected; a tree
    drafter's sibling branches cover the successor continuations, one of
    which is the trained model's greedy pick — so sibling rescue is
    exercised at the very first verify step of every row.  Tokens < 2·len
    are filler drawn from the same chain.
    """
    succ = succ_table(vocab, data_seed)
    out = np.empty((batch, prompt_len), np.int32)
    for r in range(batch):
        rng = np.random.default_rng(seed * 1009 + r)
        a, b = rng.integers(0, vocab, 2)
        branches = list(dict.fromkeys(succ[b].tolist()))[:3]
        blocks = []
        for s in branches:                 # older copies: successor walks
            walk, t = [s], s
            for _ in range(depth - 1):
                t = succ[t, 0]
                walk.append(t)
            blocks.append([a, b] + walk + [int(rng.integers(0, vocab))])
        junk = [t for t in rng.permutation(vocab)[: depth + 2]
                if t not in set(succ[b].tolist())][:depth]
        blocks.append([a, b] + junk)       # most recent copy: junk
        tail = sum(blocks, []) + [a, b]
        fill_len = prompt_len - len(tail)
        if fill_len < 0:
            raise ValueError(f"prompt_len {prompt_len} too short for "
                             f"{len(tail)} structured tokens")
        fill = synthetic_corpus(rng, fill_len, vocab, 0.0,
                                markov=(succ, 0.97)) if fill_len else []
        out[r] = np.concatenate([np.asarray(fill, np.int32),
                                 np.asarray(tail, np.int32)])
    return out


def lm_batches(
    batch: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    markov_alpha: float = 0.9,
) -> Iterator[dict]:
    """Infinite iterator of {"tokens", "labels"} with learnable structure:
    a random sparse first-order Markov chain over the vocab."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, N_SUCC))  # == succ_table(vocab, seed)
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq_len):
            follow = rng.random(batch) < markov_alpha
            pick = succ[toks[:, t], rng.integers(0, N_SUCC, batch)]
            rand = rng.integers(0, vocab, batch)
            toks[:, t + 1] = np.where(follow, pick, rand)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
