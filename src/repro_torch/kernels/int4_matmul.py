"""W4A8 GEMM: int8 activations × int4 weights packed two per byte, int32
accumulation, the per-token × per-channel dequantization epilogue — port of
``repro/kernels/int4_matmul.py``.

The packed weight is (N, K/2), K contiguous: the transpose of the
reference's (K/2, N), with the same nibble order along K (byte r of a row
holds K index 2r in its low nibble and 2r+1 in its high nibble, both
sign-extended).  ``int4_matmul`` checks its inputs, then runs the plain
version for CPU tensors and the CUDA kernel (``csrc/int4_matmul.cu``) for
CUDA tensors.  The kernel unpacks the nibbles in registers and never
writes an unpacked weight; both sum exactly in int32 and take the same f32
epilogue, so their outputs are equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.int8_matmul import int8_matmul_ref, split_k

K_ALIGN = 32     # the kernel's fast path loads packed rows in 16-byte chunks


def unpack_nk(w_packed: torch.Tensor) -> torch.Tensor:
    """(N, K/2) packed → (N, K) int8 in [-8, 7] (low nibble first)."""
    p = w_packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    return torch.stack([lo, hi], dim=2).reshape(p.shape[0], -1).to(torch.int8)


def int4_matmul_ref(x_int8, w_packed, dx, dw, out_dtype=torch.bfloat16):
    """Plain version: unpack, then the int8 GEMM's plain version (exact
    int32 sums; float64 on the card)."""
    return int8_matmul_ref(x_int8, unpack_nk(w_packed), dx, dw, out_dtype)


def _check(x, w, dx, dw, out_dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != 2 * w.shape[1]:
        raise ValueError(f"int4_matmul: need x (M, K) and packed w (N, K/2), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"int4_matmul: x and w must be int8, got {x.dtype}, {w.dtype}")
    if x.shape[1] == 0:
        raise ValueError("int4_matmul: K must be positive")
    if dx.shape != (x.shape[0],) or dw.shape != (w.shape[0],):
        raise ValueError(f"int4_matmul: dx must be ({x.shape[0]},) and dw "
                         f"({w.shape[0]},), got {tuple(dx.shape)}, {tuple(dw.shape)}")
    if dx.dtype != torch.float32 or dw.dtype != torch.float32:
        raise ValueError("int4_matmul: dx and dw must be f32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int4_matmul: out_dtype must be bf16 or f32, got {out_dtype}")
    if not all(t.is_contiguous() for t in (x, w, dx, dw)):
        raise ValueError("int4_matmul: inputs must be contiguous (w is (N, K/2), "
                         "K contiguous)")
    if len({t.device for t in (x, w, dx, dw)}) != 1:
        raise ValueError("int4_matmul: inputs are on different devices")


def _launch(x, w, dx, dw, out_dtype):
    M, K = x.shape
    N = w.shape[0]
    # 16-byte loads where every row starts 16-byte aligned; byte loads else
    aligned = K % K_ALIGN == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    k_chunk, splits = split_k(M, N, K)
    ws = (torch.zeros((M, N), dtype=torch.int32, device=x.device)
          if splits > 1 else None)
    fn = ops.c_function("int4_matmul", "int4_matmul_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    err = fn(ops.ptr(x), ops.ptr(w), ops.ptr(dx), ops.ptr(dw), ops.ptr(out),
             int(out_dtype == torch.bfloat16), ops.ptr(ws), M, N, K, k_chunk,
             splits, int(aligned), ops.stream(x))
    ops.check("int4_matmul", err)
    ops.LAUNCHES["int4_matmul"] += 1
    return out


def int4_matmul(x_int8, w_packed, dx, dw, *, out_dtype=torch.bfloat16):
    """x̂ (M, K) int8, W (N, K/2) packed int4, Δx (M,) f32, Δw (N,) f32 →
    (M, N) ``out_dtype`` = float(x̂·unpack(W)ᵀ) · Δx[m] · Δw[n]."""
    _check(x_int8, w_packed, dx, dw, out_dtype)
    return ops.dispatch(
        x_int8, lambda: int4_matmul_ref(x_int8, w_packed, dx, dw, out_dtype),
        lambda: _launch(x_int8, w_packed, dx, dw, out_dtype))
