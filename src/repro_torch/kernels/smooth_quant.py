"""Fused online activation smoothing + per-token dynamic int8 quantization
(paper Eq. 9) — port of ``repro/kernels/smooth_quant.py``.

``smooth_quant`` is the wrapper: it checks its inputs, then runs the plain
version for CPU tensors and the CUDA kernel (``csrc/smooth_quant.cu``) for
CUDA tensors.  The two are bit-identical: both round half to even and take
the same IEEE-rounded steps, and both carry a NaN in a row into its Δx (so
non-finite activations still give non-finite logits downstream).

Δx = max(amax, ε) · f32(1/127): inside ``jit`` XLA rewrites the reference's
division by the constant 127 into this multiplication by its f32
reciprocal (a true division differs in the last bit for about 4% of
inputs), and the reference's decode step is jitted.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ops

INT8_MAX = 127.0
INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))
EPS = 1e-8


def smooth_quant_ref(x: torch.Tensor, smooth: torch.Tensor):
    """Plain version.  x: (M, K), smooth: (K,) → (x̂ int8 (M, K), Δx f32 (M,))."""
    xs = x.float() * smooth.float()
    amax = xs.abs().amax(dim=-1)
    dx = amax.clamp_min(EPS) * INV_INT8_MAX
    q = torch.round(xs / dx[:, None]).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), dx


def _check(x: torch.Tensor, smooth: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"smooth_quant: x must be (M, K) bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("smooth_quant: x must be contiguous")
    if (smooth.shape != (x.shape[1],) or smooth.dtype != torch.float32
            or not smooth.is_contiguous()):
        raise ValueError(f"smooth_quant: smooth must be contiguous ({x.shape[1]},) "
                         f"f32, got {tuple(smooth.shape)} {smooth.dtype}")
    if smooth.device != x.device:
        raise ValueError("smooth_quant: x and smooth are on different devices")


def _launch(x: torch.Tensor, smooth: torch.Tensor):
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    dx = torch.empty((M,), dtype=torch.float32, device=x.device)
    fn = ops.c_function("smooth_quant", "smooth_quant_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(ops.ptr(x), int(x.dtype == torch.bfloat16), ops.ptr(smooth),
             ops.ptr(q), ops.ptr(dx), M, K, ops.stream(x))
    ops.check("smooth_quant", err)
    ops.LAUNCHES["smooth_quant"] += 1
    return q, dx


def smooth_quant(x: torch.Tensor, smooth: torch.Tensor):
    """x: (M, K) bf16/f32 contiguous, smooth: (K,) f32 →
    (x̂ int8 (M, K), Δx f32 (M,))."""
    _check(x, smooth)
    return ops.dispatch(x, lambda: smooth_quant_ref(x, smooth),
                        lambda: _launch(x, smooth))
