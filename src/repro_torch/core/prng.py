"""Per-row random streams for batch-composition-invariant sampling — port of
``repro/core/prng.py``.

Each batch row owns a ``torch.Generator`` seeded from its request's seed
alone (:func:`request_generator`), and every random number the row uses is
drawn from it.  A row's samples are then a function of (seed, own token
history) only: invariant to co-batching, slot index and batch size.
There is no global random state.  ``torch.Generator`` and ``jax.random``
give different numbers from the same seed, so tests that compare the two
hand both the same noise (``core/verification.verify`` takes it as input).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

# Salt for deriving request streams: decouples them from other uses of
# small integer seeds.
REQUEST_STREAM_SALT = 0x5EED


def request_generator(seed: int, device) -> torch.Generator:
    """The per-request generator on ``device``: a pure function of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((REQUEST_STREAM_SALT << 32) ^ (int(seed) & 0xFFFFFFFF))
    return g


def row_generators(seeds: Sequence[int], device) -> List[torch.Generator]:
    return [request_generator(s, device) for s in seeds]


def uniform_rows(gens: Sequence[torch.Generator], n: int, device) -> torch.Tensor:
    """(B, n) uniforms in [0, 1), row ``b`` from ``gens[b]``."""
    return torch.stack([torch.rand(n, generator=g, device=device) for g in gens])


def gumbel_rows(gens: Sequence[torch.Generator], n: int, device) -> torch.Tensor:
    """(B, n) standard Gumbel noise, row ``b`` from ``gens[b]``."""
    u = uniform_rows(gens, n, device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def categorical_rows(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax: (B, V) log-probabilities + (B, V) Gumbel noise → (B,)
    samples (``jax.random.categorical`` is the same rule)."""
    return torch.argmax(logits + gumbel, dim=-1)
