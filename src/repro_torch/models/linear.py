"""Linear layer with bf16 and W8A8 (quantized-verification) forms — port of
``repro/models/linear.py`` (the int4 form waits for the W4A8 slice).

* :class:`Linear` — ``w`` (din, dout) in the model dtype [+ ``b`` (dout,)].
* :class:`W8A8Linear` — what ``repro_torch.quant.apply.quantize_params``
  produces offline (paper §3.3): ``w_int8`` (dout, din) int8, ``w_scale``
  (dout,) f32, ``smooth`` (din,) f32 [+ ``b``].  The int8 weight is stored
  **(dout, din) = (N, K), K contiguous** — the transpose of the reference's
  (din, dout) — because the int8 tensor-core GEMM reads four consecutive K
  values of one output column per register; it is transposed once, at
  quantization (and in the bridge), never per call.

At run time the activations are smoothed and quantized per token (Eq. 9),
the GEMM runs in int8 and the result is dequantized by Δw·Δx (Eq. 10).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init


class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)

    @classmethod
    def init(cls, generator, d_in: int, d_out: int, bias: bool, dtype, device):
        b = torch.zeros(d_out, dtype=dtype, device=device) if bias else None
        return cls(dense_init(generator, (d_in, d_out), dtype, device), b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        return y + self.b.to(y.dtype) if self.b is not None else y


class W8A8Linear(nn.Module):
    def __init__(self, w_int8: torch.Tensor, w_scale: torch.Tensor,
                 smooth: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w_int8", w_int8)      # (dout, din), din contiguous
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("smooth", smooth)
        self.register_buffer("b", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.w8a8_matmul(x, self.w_int8, self.w_scale, self.smooth)
        return y + self.b.to(y.dtype) if self.b is not None else y

