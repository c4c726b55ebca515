"""W8A8 int8 GEMM with int32 accumulation and the per-token × per-channel
dequantization epilogue (paper Eq. 8 / 10) — port of
``repro/kernels/int8_matmul.py``.

The weight is (N, K), K contiguous: the transpose of the reference's
(K, N) layout (see ``csrc/int8_matmul.cu`` for why).  ``int8_matmul``
checks its inputs, then runs the plain version for CPU tensors and the
CUDA kernel for CUDA tensors.  The integer sum is exact on both, and the
epilogue is the same sequence of f32 roundings, so outputs are equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops

BM = BN = BK = 64          # the kernel's output and K tile sizes
NUM_SMS = 132              # H100 SXM
K_ALIGN = 16               # the kernel loads rows in 16-byte chunks


def int32_acc(x_int8: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """Exact int32 X̂·Wᵀ.  ``int8 @ int8`` wraps in int8, and CUDA has no
    int32 matmul; float64 is exact there, since |acc| ≤ 127²·K < 2⁵³."""
    if x_int8.device.type == "cpu":
        return x_int8.to(torch.int32) @ w_nk.to(torch.int32).T
    return (x_int8.double() @ w_nk.double().T).to(torch.int32)


def int8_matmul_ref(x_int8, w_nk, dx, dw, out_dtype=torch.bfloat16):
    """Plain version: (M, K) int8 × (N, K) int8 → (M, N) ``out_dtype``."""
    acc = int32_acc(x_int8, w_nk)
    y = acc.float() * dx[:, None] * dw[None, :]
    return y.to(out_dtype)


def _check(x, w, dx, dw, out_dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"int8_matmul: need x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"int8_matmul: x and w must be int8, got {x.dtype}, {w.dtype}")
    K = x.shape[1]
    if K == 0 or K % K_ALIGN:
        raise ValueError(f"int8_matmul: K={K} must be a positive multiple of {K_ALIGN}")
    if dx.shape != (x.shape[0],) or dw.shape != (w.shape[0],):
        raise ValueError(f"int8_matmul: dx must be ({x.shape[0]},) and dw "
                         f"({w.shape[0]},), got {tuple(dx.shape)}, {tuple(dw.shape)}")
    if dx.dtype != torch.float32 or dw.dtype != torch.float32:
        raise ValueError("int8_matmul: dx and dw must be f32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul: out_dtype must be bf16 or f32, got {out_dtype}")
    if not all(t.is_contiguous() for t in (x, w, dx, dw)):
        raise ValueError("int8_matmul: inputs must be contiguous (w is (N, K), "
                         "K contiguous)")
    if len({t.device for t in (x, w, dx, dw)}) != 1:
        raise ValueError("int8_matmul: inputs are on different devices")


def split_k(M: int, N: int, K: int) -> tuple[int, int]:
    """(k_chunk, splits): split K across blocks when the output has too few
    64×64 tiles to keep four blocks on every SM (decode shapes)."""
    tiles = -(-M // BM) * -(-N // BN)
    ktiles = -(-K // BK)
    want = max(1, min(-(-4 * NUM_SMS // tiles), ktiles // 4))
    per = -(-ktiles // want)
    return per * BK, -(-ktiles // per)


def _launch(x, w, dx, dw, out_dtype):
    M, K = x.shape
    N = w.shape[0]
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8_matmul: the kernel loads rows in 16-byte chunks; "
                         "x and w must be 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    k_chunk, splits = split_k(M, N, K)
    ws = (torch.zeros((M, N), dtype=torch.int32, device=x.device)
          if splits > 1 else None)
    fn = ops.c_function("int8_matmul", "int8_matmul_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(ops.ptr(x), ops.ptr(w), ops.ptr(dx), ops.ptr(dw), ops.ptr(out),
             int(out_dtype == torch.bfloat16), ops.ptr(ws), M, N, K, k_chunk,
             splits, ops.stream(x))
    ops.check("int8_matmul", err)
    ops.LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul(x_int8, w_nk, dx, dw, *, out_dtype=torch.bfloat16):
    """x̂ (M, K) int8, W (N, K) int8, Δx (M,) f32, Δw (N,) f32 →
    (M, N) ``out_dtype`` = float(x̂·Wᵀ) · Δx[m] · Δw[n]."""
    _check(x_int8, w_nk, dx, dw, out_dtype)
    return ops.dispatch(
        x_int8, lambda: int8_matmul_ref(x_int8, w_nk, dx, dw, out_dtype),
        lambda: _launch(x_int8, w_nk, dx, dw, out_dtype))
