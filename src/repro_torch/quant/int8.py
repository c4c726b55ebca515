"""Symmetric INT8 weight quantization (paper Eq. 6) — port of
``repro/quant/int8.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import quantize_symmetric
from repro_torch.models.linear import ExpertLinear, Linear, W8A8ExpertLinear, W8A8Linear


def quantize_linear(p: Linear, smooth: torch.Tensor) -> W8A8Linear:
    """Smooth (``W·diag(s)^-1``, paper §3.3), then quantize symmetrically per
    output channel.  The int8 weight is stored transposed, (dout, din) with
    din contiguous, for the int8 GEMM kernel (see models/linear.py)."""
    w = p.w.float() / smooth[:, None]
    w_int8, w_scale = quantize_symmetric(w, dim=0)   # Δw per out-channel (dout,)
    return W8A8Linear(w_int8.T.contiguous(), w_scale, smooth.float(), p.b)


def quantize_batched(p: ExpertLinear, smooth: torch.Tensor) -> W8A8ExpertLinear:
    """Quantize batched expert weights (E, din, dout): smooth by the one
    ``s`` (din,) the experts share, then per expert and output channel
    (Δw (E, dout)); stored (E, dout, din), din contiguous."""
    w = p.w.float() / smooth[None, :, None]
    w_int8, w_scale = quantize_symmetric(w, dim=1)   # Δw per expert, out-channel (E, dout)
    return W8A8ExpertLinear(w_int8.transpose(1, 2).contiguous(), w_scale, smooth.float())
