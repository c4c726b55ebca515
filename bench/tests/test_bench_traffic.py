"""The traffic generators: seeded and repeatable, every seed the same set
of sizes and gaps in its own order."""
import json

import numpy as np

import tiny_cell  # noqa: F401
from benchkit.spec import Bench

BENCH = Bench(tiny_cell.REPO)


def test_backlog_is_seeded_staggered_and_endless():
    mix = BENCH.mix("backlog-1k")
    gen = BENCH.generator("backlog")
    a, b = gen(mix, 151936, 2 ** 31 + 5, 30), gen(mix, 151936, 2 ** 31 + 5, 30)
    c = gen(mix, 151936, 2 ** 31 + 6, 30)
    n = 260
    # request i comes from (seed, i) alone, in whatever order it is asked for
    ra = [a.requests[i] for i in range(n)]
    rb = [b.requests[i] for i in reversed(range(n))][::-1]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(ra, rb))
    assert not np.array_equal(a.requests[0].prompt, c.requests[0].prompt)
    assert all(len(r.prompt) == 1024 and r.due is None for r in ra)
    slots = mix["slots"]
    warm = [r.new_tokens for r in ra if r.warm]
    assert len(warm) == slots and warm[-1] == 256 and warm == sorted(warm) and warm[0] >= 1
    assert all(r.new_tokens == 256 for r in ra if not r.warm)
    assert a.slots == slots and a.depth == mix["depth"]
    # no end: a faster program asks for more requests and gets them
    assert len(a.requests[10 ** 6].prompt) == 1024


def test_poisson_same_work_for_every_seed():
    mix = {"kind": "poisson", "slots": 16, "rate": 6.4, "prompt_len": [128, 1024],
           "new_tokens": [16, 256], "tasks": ["mtbench", "alpaca"], "warm_s": 8.0,
           "tail_s": 20.0, "shape_seed": 29}
    gen = BENCH.generator("poisson")
    a, b = gen(mix, 151936, 7, 10), gen(mix, 151936, 7, 10)
    c = gen(mix, 151936, 2 ** 31 + 99, 10)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a.requests, b.requests))
    # the same sizes at the same times, other tokens
    assert [(r.due, len(r.prompt), r.new_tokens) for r in a.requests] == \
        [(r.due, len(r.prompt), r.new_tokens) for r in c.requests]
    assert not np.array_equal(a.requests[0].prompt, c.requests[0].prompt)
    n = len(a.requests)
    assert n == int(np.ceil(mix["rate"] * (mix["warm_s"] + 10 + mix["tail_s"])))
    gaps = np.diff([r.due for r in a.requests])
    assert (gaps > 0).all() and abs(gaps.mean() * mix["rate"] - 1) < 0.2
    lens = [len(r.prompt) for r in a.requests]
    assert min(lens) >= 128 and max(lens) <= 1024 and len(set(lens)) > 50
    assert all(16 <= r.new_tokens <= 256 for r in a.requests)
    assert a.requests[0].due < 0 and a.requests[0].warm     # arrivals before the window
    assert a.max_prompt_len == 1024 and a.max_new_tokens == 256


def test_prompts_carry_the_task_repetition():
    from traffic.prompts import prompt

    rng = np.random.default_rng(3)
    p = prompt(rng, 1024, 151936, "gsm8k")
    # a 60% copy preset repeats many 4-grams of the prompt
    grams = [tuple(p[i:i + 4]) for i in range(len(p) - 3)]
    assert len(set(grams)) < 0.8 * len(grams)
    assert p.dtype == np.int32 and p.min() >= 0 and p.max() < 151936


def test_mix_files_name_their_generator():
    for path in (tiny_cell.BENCH / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        assert (tiny_cell.BENCH / "traffic" / f"{mix['kind']}.py").exists()
