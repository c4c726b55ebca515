"""Plain PyTorch versions of the kernels — port of ``repro/kernels/ref.py``.

Each kernel's plain version lives beside its wrapper; this module gathers
them with the oracles that are not kernels: symmetric quantization
(Eq. 6-7) and the full W8A8 and W4A8 linears.  The int8 weight is (N, K)
and the packed int4 weight (N, K/2), the transposes of the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import flash_decode_ref  # noqa: F401
from repro_torch.kernels.int4_matmul import int4_matmul_ref
from repro_torch.kernels.int8_matmul import int8_matmul_ref
from repro_torch.kernels.smooth_quant import EPS, INT8_MAX, smooth_quant_ref


def quantize_symmetric(x: torch.Tensor, dim: int):
    """Symmetric uniform quantization Q(x, Δ) (paper Eq. 6-7): returns
    (int8 values, scale Δ reduced over ``dim``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=dim)
    scale = amax.clamp_min(EPS) / torch.full((), INT8_MAX, device=x.device)
    q = torch.round(x32 / scale.unsqueeze(dim)).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def w8a8_matmul_ref(x, w_int8, w_scale, smooth, out_dtype=None):
    """Full W8A8 linear: smooth + quantize x, int8 GEMM, dequant."""
    out_dtype = out_dtype or x.dtype
    batch_shape = x.shape[:-1]
    xq, dx = smooth_quant_ref(x.reshape(-1, x.shape[-1]), smooth)
    y = int8_matmul_ref(xq, w_int8, dx, w_scale, out_dtype)
    return y.reshape(*batch_shape, w_int8.shape[0])


def w4a8_matmul_ref(x, w_int4, w_scale, smooth, out_dtype=None):
    """Full W4A8 linear: smooth + quantize x, W4A8 GEMM, dequant."""
    out_dtype = out_dtype or x.dtype
    batch_shape = x.shape[:-1]
    xq, dx = smooth_quant_ref(x.reshape(-1, x.shape[-1]), smooth)
    y = int4_matmul_ref(xq, w_int4, dx, w_scale, out_dtype)
    return y.reshape(*batch_shape, w_int4.shape[0])
