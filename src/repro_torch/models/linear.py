"""Linear layer with bf16, W8A8 and W4A8 (quantized-verification) forms —
port of ``repro/models/linear.py``.

* :class:`Linear` — ``w`` (din, dout) in the model dtype [+ ``b`` (dout,)].
  On the card a call of at most ``WINDOW_ROWS`` rows (every decode and
  verify window) runs as zero-padded GEMMs of ``FIXED_ROWS`` rows each:
  cuBLAS picks its kernel, and with it the sum order, from the row count
  (a row of a 12-row call at (4096, 4096) differed from the same row in a
  2-row call), so a row's bits then depend on neither the window nor the
  batch.  One shape for every window would be 256 rows, which made the 7B
  bf16 step compute-bound (+3 ms); 32-row chunks cost a chain window
  nothing and read the weights once per 32 rows of a wider one.
* :class:`W8A8Linear` — what ``repro_torch.quant.apply.quantize_params``
  produces offline (paper §3.3): ``w_int8`` (dout, din) int8, ``w_scale``
  (dout,) f32, ``smooth`` (din,) f32 [+ ``b``].  The int8 weight is stored
  **(dout, din) = (N, K), K contiguous** — the transpose of the reference's
  (din, dout) — because the int8 tensor-core GEMM reads four consecutive K
  values of one output column per register; it is transposed once, at
  quantization (and in the bridge), never per call.
* :class:`W4A8Linear` — ``w_int4`` (dout, din/2) int8, two int4 weights
  per byte along din (``repro_torch.quant.int4``), with ``w_scale``,
  ``smooth`` [+ ``b``] as above: the verify pass streams 0.5 byte per
  weight.
* :class:`ExpertLinear` / :class:`W8A8ExpertLinear` — an MoE layer's
  batched expert weights (``models/moe.py``): ``w`` (E, din, dout), or
  ``w_int8`` (E, dout, din) with ``w_scale`` (E, dout) and one ``smooth``
  (din,) shared by the experts (``quant.int8.quantize_batched``).

At run time the activations are smoothed and quantized per token (Eq. 9),
the GEMM runs in int8 and the result is dequantized by Δw·Δx (Eq. 10).
``forward`` does both; ``forward_quantized`` takes codes and scales that
an RMSNorm already made for this linear (``models/common.Norm``, one
``norm_smooth_quant`` launch for every linear reading the norm).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, fixed_rows_matmul

FIXED_ROWS = 32    # rows of each GEMM of a bf16 linear's window on the card
WINDOW_ROWS = 256  # calls up to this many rows (decode and verify) take them


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
        w = self.w.to(x.dtype)
        rows = x.numel() // x.shape[-1]
        if x.device.type == "cuda" and 0 < rows <= WINDOW_ROWS:
            y = fixed_rows_matmul(x.reshape(rows, -1), w, FIXED_ROWS).view(*x.shape[:-1], -1)
        else:
            y = x @ w
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

    def forward_quantized(self, xq, dx, batch_shape, out_dtype) -> torch.Tensor:
        """x̂ (M, K) int8 and Δx (M,) made with this linear's ``smooth`` →
        (*batch_shape, dout) in ``out_dtype``."""
        y = ops.w8a8_gemm(xq, dx, self.w_int8, self.w_scale, batch_shape, out_dtype)
        return y + self.b.to(y.dtype) if self.b is not None else y


class W4A8Linear(nn.Module):
    def __init__(self, w_int4: torch.Tensor, w_scale: torch.Tensor,
                 smooth: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w_int4", w_int4)      # (dout, din/2), din contiguous
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("smooth", smooth)
        self.register_buffer("b", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.w4a8_matmul(x, self.w_int4, self.w_scale, self.smooth)
        return y + self.b.to(y.dtype) if self.b is not None else y

    def forward_quantized(self, xq, dx, batch_shape, out_dtype) -> torch.Tensor:
        """As :meth:`W8A8Linear.forward_quantized`, through the W4A8 GEMM."""
        y = ops.w4a8_gemm(xq, dx, self.w_int4, self.w_scale, batch_shape, out_dtype)
        return y + self.b.to(y.dtype) if self.b is not None else y


class ExpertLinear(nn.Module):
    """Batched expert weights ``w`` (E, din, dout): x (E, C, din) → (E, C,
    dout), the reference's ``einsum("ecd,edf->ecf")`` as one ``bmm``
    (``rows``, the kept rows per expert, is not read: every row is
    computed)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)

    def forward(self, x: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
        return torch.bmm(x, self.w.to(x.dtype))


class W8A8ExpertLinear(nn.Module):
    """W8A8 expert weights: ``w_int8`` (E, dout, din), din contiguous (the
    transpose of the reference's (E, din, dout), for the same reason as
    :class:`W8A8Linear`), ``w_scale`` (E, dout) f32, ``smooth`` (din,) f32.
    ``rows`` (E,) int32, the kept rows per expert: rows past them come out
    +0 (what the reference's product gives the zero rows gathered there),
    and an expert with none reads no weight on the card."""

    def __init__(self, w_int8: torch.Tensor, w_scale: torch.Tensor, smooth: torch.Tensor):
        super().__init__()
        self.register_buffer("w_int8", w_int8)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("smooth", smooth)

    def forward(self, x: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
        return ops.w8a8_expert_matmul(x, self.w_int8, self.w_scale, self.smooth, rows)
