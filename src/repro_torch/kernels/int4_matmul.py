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
epilogue, so their outputs are equal.  Its launch is planned here from the
shapes and pointers alone (:func:`gemm_plan`), with the int8 GEMM's
swapped-regime logic (``int8_matmul.swap_plan``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.int8_matmul import (KT, MAX_STAGES, SMALL_M, SMEM_PER_BLOCK,
                                             SMEM_RESERVE, Plan, int8_matmul_ref,
                                             swap_plan)

K_ALIGN = 32     # TMA streams packed rows in 16-byte units: K/2 % 16 == 0
KP = KT // 2     # packed W bytes per row and ring stage


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


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, aligned: bool = True) -> Plan:
    """The card kernel's launch, chosen from the shapes and, through
    ``aligned`` (both base pointers 16-byte aligned), the pointers alone.

    The operands are always swapped (W rows are wgmma's A, from registers
    after the unpack).  M <= 256: :func:`~repro_torch.kernels.int8_matmul.swap_plan`
    with 64-byte packed W rows per stage, so each packed byte is read once.
    M > 256: 128 W rows by 256 X rows per block, X tiled over a second grid
    dimension, no K split, as many stages as fit.  The producer streams with
    TMA when the rows are 16-byte multiples (K % 32 == 0) and aligned, else
    it stages the same swizzled layout with byte loads."""
    tma = aligned and K % K_ALIGN == 0
    if M > SMALL_M:
        stage = 128 * KP + 256 * KT
        stages = min(MAX_STAGES, (SMEM_PER_BLOCK - SMEM_RESERVE) // stage)
        return Plan("tiled", 128, 256, 1, stages, SMEM_RESERVE + stages * stage, tma)
    return swap_plan(M, N, K, KP, tma)


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = ops.c_function("int4_matmul", "int4_matmul_launch",
                             [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p])
    return _FN


def _launch(x, w, dx, dw, out_dtype):
    M, K = x.shape
    N = w.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    plan = gemm_plan(M, N, K, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn()(x.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                       out.data_ptr(), out_dtype == torch.bfloat16, M, N, K, plan.width,
                       plan.tile_n, plan.cluster, plan.stages, plan.smem, plan.tma, stream)
    ops.check("int4_matmul", err)
    ops.LAUNCHES["int4_matmul"] += 1
    return out


def int4_matmul(x_int8, w_packed, dx, dw, *, out_dtype=torch.bfloat16):
    """x̂ (M, K) int8, W (N, K/2) packed int4, Δx (M,) f32, Δw (N,) f32 →
    (M, N) ``out_dtype`` = float(x̂·unpack(W)ᵀ) · Δx[m] · Δw[n]."""
    _check(x_int8, w_packed, dx, dw, out_dtype)
    return ops.dispatch(
        x_int8, lambda: int4_matmul_ref(x_int8, w_packed, dx, dw, out_dtype),
        lambda: _launch(x_int8, w_packed, dx, dw, out_dtype), (dx, dw))
