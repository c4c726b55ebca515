"""The work of each kernel family (``bench/kernels/<family>.json``'s
``count``) over a part of a run: its decode steps ``(t, live rows,
committed, context sum)`` and its admissions ``(t, prompt length)``."""
from __future__ import annotations

from typing import Optional

from benchkit import counts


def dense_gemm(run, steps, admissions) -> Optional[counts.Work]:
    """Every int8 linear: the verify window's rows of
    each live row (``lm_head`` included), and each prompt's rows but its
    last (no ``lm_head``)."""
    d, w = run.dims, counts.Work()
    for _, live, _, _ in steps:
        w = w + counts.dense_gemm(d, live * run.window, logits=True)
    for _, P in admissions:
        w = w + counts.dense_gemm(d, P - 1, logits=False)
    return w if (steps or admissions) else None


def paged_attn(run, steps, admissions) -> Optional[counts.Work]:
    """The paged cache read of each verify step."""
    w = counts.Work()
    for _, live, _, ctx in steps:
        w = w + counts.paged_attn(run.dims, run.window, live, ctx)
    return w if steps else None

