"""Seeded raw weights, made by the benchmark on the device in a few large
calls, and handed both to the program and to the plain reference.  Their
names, shapes and distributions are the layout of the configuration's
reference (its ``layout(model)``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make(spec: Sequence[Tuple[str, tuple, torch.dtype, float]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """Every weight of ``spec`` from ``seed``: one flat buffer per dtype,
    filled by one ``normal_`` from a generator on ``device``, each weight a
    view scaled in place by its std (std 0: ones)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    out: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(dt for _, _, dt, _ in spec):
        group = [s for s in spec if s[2] == dtype]
        total = sum(_numel(shape) for _, shape, _, _ in group)
        flat = torch.empty(total, dtype=dtype, device=device)
        flat.normal_(generator=gen)
        at = 0
        for name, shape, _, std in group:
            n = _numel(shape)
            w = flat[at:at + n].view(shape)
            at += n
            if std == 0.0:
                w.fill_(1.0)
            else:
                w.mul_(std)
            out[name] = w
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
