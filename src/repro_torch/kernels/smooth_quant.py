"""Fused online activation smoothing + per-token dynamic int8 quantization
(paper Eq. 9) — port of ``repro/kernels/smooth_quant.py`` — and the same
fused with the RMSNorm before it, for every linear that reads the norm.

``smooth_quant`` and ``norm_smooth_quant`` are the wrappers: they check
their inputs, then run the plain version for CPU tensors and the CUDA
kernel (``csrc/smooth_quant.cu``) for CUDA tensors.  The two are
bit-identical: both round half to even and take the same IEEE-rounded
steps, and both carry a NaN in a row into its Δx (so non-finite activations
still give non-finite logits downstream).

Δx = max(amax, ε) · f32(1/127): inside ``jit`` XLA rewrites the reference's
division by the constant 127 into this multiplication by its f32
reciprocal (a true division differs in the last bit for about 4% of
inputs), and the reference's decode step is jitted.

``norm_smooth_quant`` normalizes a row as ``models/common.rms_norm`` does,
y = x·(1/√(mean(x²) + eps))·scale rounded to x's dtype, but sums the squares
in the order its kernel fixes (:func:`row_sum_squares`), so a row's bits do
not depend on how many rows share the call, and takes 1/√ as an IEEE
division by an IEEE square root; then it quantizes y for each linear's
smooth vector exactly as ``smooth_quant`` does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

INT8_MAX = 127.0
INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))
EPS = 1e-8
THREADS = 256                  # the kernel's threads per row (csrc/smooth_quant.cu)
MAX_CHUNKS_PER_THREAD = 8      # chunks of one 16-byte vector a thread holds (norm)
MAX_QUANT_CHUNKS_PER_THREAD = 16   # the same for smooth_quant alone (a 28672-wide down)
MAX_NORM_READERS = 3           # q/k/v read attn_norm


def chunk(dtype: torch.dtype) -> int:
    """Elements of one 16-byte vector: a thread's unit of the row."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def max_width(dtype: torch.dtype) -> int:
    """The widest row ``norm_smooth_quant``'s kernel holds in registers."""
    return MAX_CHUNKS_PER_THREAD * THREADS * chunk(dtype)


def max_quant_width(dtype: torch.dtype) -> int:
    """The widest row ``smooth_quant``'s kernel holds in registers (twice
    the norm's: llama-3.2-vision's down projection reads 28672)."""
    return MAX_QUANT_CHUNKS_PER_THREAD * THREADS * chunk(dtype)


def smooth_quant_ref(x: torch.Tensor, smooth: torch.Tensor):
    """Plain version.  x: (M, K), smooth: (K,) → (x̂ int8 (M, K), Δx f32 (M,))."""
    xs = x.float() * smooth.float()
    amax = xs.abs().amax(dim=-1)
    dx = amax.clamp_min(EPS) * INV_INT8_MAX
    q = torch.round(xs / dx[:, None]).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), dx


def row_sum_squares(x32: torch.Tensor, c: int) -> torch.Tensor:
    """Σ x² of each row of (M, D) f32 in the kernel's order: thread t of
    ``THREADS`` adds the squares of chunks t, t + THREADS, … (``c``
    elements each, the row zero-padded) in index order; the 32 partials of
    a warp are summed by the shuffle tree xor 16, 8, 4, 2, 1; the warps'
    sums are added in warp order.  Elementwise f32 adds, so the bits are the
    kernel's on any device.  → (M,) f32."""
    M, D = x32.shape
    rounds = -(-D // (c * THREADS))
    sq = F.pad(x32, (0, rounds * THREADS * c - D))
    sq = (sq * sq).view(M, rounds, THREADS, c)
    part = torch.zeros((M, THREADS), dtype=torch.float32, device=x32.device)
    for r in range(rounds):
        for e in range(c):
            part = part + sq[:, r, :, e]
    part = part.view(M, THREADS // 32, 32)
    lane = torch.arange(32, device=x32.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, :, lane ^ o]
    total = part[:, 0, 0]
    for w in range(1, THREADS // 32):
        total = total + part[:, w, 0]
    return total


def rms_norm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's RMSNorm of (M, D) rows, in x's dtype (plain version)."""
    x32 = x.float()
    inv_d = float(np.float32(1.0) / np.float32(x.shape[1]))
    var = row_sum_squares(x32, chunk(x.dtype)) * inv_d
    inv = torch.reciprocal(torch.sqrt(var + float(np.float32(eps))))
    return ((x32 * inv[:, None]) * scale.float()).to(x.dtype)


def norm_smooth_quant_ref(x, scale, eps, smooths):
    """Plain version: :func:`rms_norm_rows`, then :func:`smooth_quant_ref`
    for each smooth vector → [(x̂ int8 (M, D), Δx f32 (M,)), ...].  Used by
    the tests and to hold the kernel; the model's CPU path keeps the
    reference's composition."""
    y = rms_norm_rows(x, scale, eps)
    return [smooth_quant_ref(y, s) for s in smooths]


def _check(x: torch.Tensor, smooth: torch.Tensor, name: str = "smooth_quant",
           widest=max_quant_width) -> None:
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be (M, K) bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if (smooth.shape != (x.shape[1],) or smooth.dtype != torch.float32
            or not smooth.is_contiguous()):
        raise ValueError(f"{name}: smooth and scale must be contiguous ({x.shape[1]},) "
                         f"f32, got {tuple(smooth.shape)} {smooth.dtype}")
    if smooth.device != x.device:
        raise ValueError(f"{name}: x and smooth are on different devices")
    if x.device.type == "cuda" and not 0 < x.shape[1] <= widest(x.dtype):
        raise ValueError(f"{name}: the kernel holds rows of 1 to {widest(x.dtype)} "
                         f"{x.dtype} values in registers, got {x.shape[1]}")


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
                        lambda: _launch(x, smooth), (smooth,))


def _launch_norm(x, scale, eps, smooths):
    M, D = x.shape
    outs = [(torch.empty((M, D), dtype=torch.int8, device=x.device),
             torch.empty((M,), dtype=torch.float32, device=x.device)) for _ in smooths]
    pad = [None] * (MAX_NORM_READERS - len(smooths))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = ops.c_function("smooth_quant", "norm_smooth_quant_launch",
                        [p, i, p, f, f, i, p, p, p, p, p, p, p, p, p, i, i, p])
    err = fn(ops.ptr(x), int(x.dtype == torch.bfloat16), ops.ptr(scale), float(eps),
             float(np.float32(1.0) / np.float32(D)), len(smooths),
             *[ops.ptr(s) for s in [*smooths, *pad]],
             *[ops.ptr(q) for q, _ in outs], *[None] * len(pad),
             *[ops.ptr(dx) for _, dx in outs], *[None] * len(pad), M, D, ops.stream(x))
    ops.check("smooth_quant", err)
    ops.LAUNCHES["norm_smooth_quant"] += 1
    return outs


def norm_smooth_quant(x: torch.Tensor, scale: torch.Tensor, eps: float, smooths):
    """RMSNorm (``scale`` (D,) f32, ``eps``) of x (M, D) bf16/f32 contiguous,
    then per-token smoothing and int8 quantization for each of the 1-3
    ``smooths`` ((D,) f32) → [(x̂ int8 (M, D), Δx f32 (M,)), ...], one per
    smooth vector, in one launch on the card."""
    smooths = list(smooths)
    if not 1 <= len(smooths) <= MAX_NORM_READERS:
        raise ValueError(f"norm_smooth_quant: 1 to {MAX_NORM_READERS} smooth vectors, "
                         f"got {len(smooths)}")
    for s in (scale, *smooths):
        _check(x, s, "norm_smooth_quant", max_width)
    return ops.dispatch(x, lambda: norm_smooth_quant_ref(x, scale, eps, smooths),
                        lambda: _launch_norm(x, scale, eps, smooths), (scale, *smooths))
