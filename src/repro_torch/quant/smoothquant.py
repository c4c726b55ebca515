"""Enhanced-SmoothQuant ("m2") offline calibration (paper §3.2) — port of
``repro/quant/smoothquant.py``.

Calibration runs the model with a ``collect`` dict threaded through the
forward pass; every linear apply-site records the per-input-channel
absolute max of its activations under its param path.
:func:`smoothing_factors` then computes

    s_j = max|X_j|^alpha / max|W_j|^(1-alpha)        (Eq. 5)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.common import powf

EPS = 1e-5


def record_act_stats(collect: Dict[str, torch.Tensor], path: str, x: torch.Tensor) -> None:
    """Apply-site hook: fold |x| channel maxima into the collector."""
    a = x.float().abs().reshape(-1, x.shape[-1]).amax(dim=0)
    prev = collect.get(path)
    collect[path] = a if prev is None else torch.maximum(prev, a)


def smoothing_factors(w: torch.Tensor, act_amax: torch.Tensor | None,
                      alpha: float = 0.5) -> torch.Tensor:
    """Per-input-channel smoothing vector s (Eq. 5) of a (din, dout) weight.

    The "m2" enhancement: clamp into [1/8, 8] and fall back to s = 1 when no
    activation statistics exist.  The powers are taken on the host with
    libm ``powf`` (a (din,) vector), as the reference's are.
    """
    din = w.shape[-2]
    if act_amax is None:
        return torch.ones(din, dtype=torch.float32, device=w.device)
    w_amax = w.float().abs().reshape(-1, din, w.shape[-1]).amax(dim=(0, 2))
    a = np.maximum(act_amax.float().cpu().numpy(), np.float32(EPS))
    wm = np.maximum(w_amax.cpu().numpy(), np.float32(EPS))
    s = powf(a, np.float32(alpha)) / powf(wm, np.float32(1.0 - alpha))
    s = np.clip(s, np.float32(0.125), np.float32(8.0)).astype(np.float32)
    return torch.from_numpy(s).to(w.device)
