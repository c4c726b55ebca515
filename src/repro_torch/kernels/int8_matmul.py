"""W8A8 int8 GEMM with int32 accumulation and the per-token × per-channel
dequantization epilogue (paper Eq. 8 / 10) — port of
``repro/kernels/int8_matmul.py`` — and its batched form over experts.

The weight is (N, K), K contiguous: the transpose of the reference's
(K, N) layout (see ``csrc/int8_matmul.cu`` for why).  ``int8_matmul``
checks its inputs, then runs the plain version for CPU tensors and the
CUDA kernel for CUDA tensors.  The integer sum is exact on both, and the
epilogue is the same sequence of f32 roundings, so outputs are equal.

``int8_matmul_batched`` is the W8A8 branch of the reference's MoE expert
product (``repro/models/moe.py:72-87`` ``_expert_linear``, a jnp
``dot_general`` over experts, no Pallas kernel): x̂ (E, C, K) × W (E, N, K)
→ (E, C, N), one launch of the same kernel with an expert grid dimension.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ops

NUM_SMS = 132              # H100 SXM
K_ALIGN = 16               # the kernels load rows in 16-byte units


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


def int8_matmul_batched_ref(x_int8, w_enk, dx, dw, out_dtype=torch.bfloat16):
    """Plain version of the batched product: x̂ (E, C, K) int8 × W (E, N, K)
    int8 → (E, C, N) ``out_dtype`` = (float(acc) · Δx[e, c]) · Δw[e, n], the
    reference's order.  One exact :func:`int32_acc` per expert, so the card
    allocates one expert's float64 operands at a time."""
    acc = torch.stack([int32_acc(x_int8[e], w_enk[e]) for e in range(x_int8.shape[0])])
    y = acc.float() * dx[:, :, None] * dw[:, None, :]
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


# -- the card kernel's launch plan (csrc/int8_matmul.cu) ----------------------

KT = 128                   # K bytes per pipeline stage (one 128-byte swizzled row)
SMALL_M = 256              # M up to here: swapped operands, W read once
S8_WIDTHS = (8, 16, 24, 32, *range(48, 257, 16))   # N of wgmma.m64nNk32 for s8
# the widths the kernel is built for: the main path's windows (M 4, 24, 48,
# 88, 176 → 8, 24, 48, 96, 192) and the swapped regime's end
WIDTHS = (8, 24, 48, 96, 192, 256)
MAX_CLUSTER = 8            # portable thread-block cluster size
MAX_STAGES = 8
SMEM_PER_SM = 233472       # 228 KB per SM; each resident block also holds 1 KB
SMEM_PER_BLOCK = 232448    # 227 KB
SMEM_RESERVE = 2048        # the kernel's alignment slack and mbarriers


class Plan(NamedTuple):
    regime: str     # "swap" (M <= 256, Y^T tiles) or "tiled" (M > 256)
    tile_n: int     # N extent of a block's output tile (W rows per block)
    width: int      # wgmma N: M rounded up to a built width (swap), else 256
    cluster: int    # blocks of a cluster splitting K (1, 2, 4 or 8)
    stages: int     # depth of the TMA ring
    smem: int       # dynamic shared memory bytes per block
    tma: bool = True  # the producer streams with TMA (else ordinary loads)


def _every_rank_has_k(ktiles: int, cluster: int) -> bool:
    """A split of ``ktiles`` K steps over ``cluster`` blocks, ⌈ktiles/cluster⌉
    each, leaves the last block at least one."""
    return (cluster - 1) * -(-ktiles // cluster) < ktiles


def swap_plan(M: int, N: int, K: int, w_row_bytes: int, tma: bool = True,
              experts: int = 1) -> Plan:
    """The swapped regime of both s8 GEMMs (``csrc/gemm_s8.cuh``), M <= 256:
    W tiles are wgmma's A, all M rows of X its N, so each weight byte is
    read once.  ``w_row_bytes``: bytes of one W row in a ring stage (128 for
    int8, 64 for packed int4).  ``experts``: the batched product's grid
    holds that many copies of one expert's W tiles.

    One 64-row W tile per consumer warpgroup (two above width 48); up to
    three blocks per SM; K split across a cluster (a split costs two
    cluster barriers and a reduction) only while the W tiles alone leave
    SMs idle, only as far as the card holds the grid at once, and only
    while every block of the cluster keeps a K step."""
    ktiles = -(-K // KT)
    width = next(w for w in WIDTHS if w >= M)
    # one warpgroup per 64 W rows up to width 48: at gate/up M 30 it beat two
    # per 128 (fewer tiles, so a K split) by 15% (PERF.md §6, PR 15)
    tile_n = 64 if width <= 48 else 128
    stage = tile_n * w_row_bytes + width * KT
    for per_sm in (3, 2, 1):    # the most blocks per SM that leave four stages
        room = min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - 1024) - SMEM_RESERVE
        stages = min(MAX_STAGES, room // stage)
        if stages >= 4 or per_sm == 1:
            break
    tiles = -(-N // tile_n) * experts
    cluster = 1
    while (cluster * 2 <= MAX_CLUSTER and _every_rank_has_k(ktiles, cluster * 2)
           and tiles * cluster < NUM_SMS and tiles * cluster * 2 <= NUM_SMS * per_sm):
        cluster *= 2
    # a split stores every consumer thread's width/2 int32 sums in the ring
    partial = 4 * (tile_n * 2) * (width // 2) if cluster > 1 else 0
    return Plan("swap", tile_n, width, cluster, stages,
                SMEM_RESERVE + max(stages * stage, partial), tma)


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, E: int = 1) -> Plan:
    """The card kernel's launch, chosen from the shapes alone: M <= 256 the
    swapped regime (:func:`swap_plan`); M > 256 128 x 256 output tiles, X
    the A operand and W the B operand, four stages.  ``E`` > 1: the batched
    product, M = C rows per expert, every expert's tiles in one grid."""
    if M > SMALL_M:
        stage = (128 + 256) * KT
        return Plan("tiled", 256, 256, 1, 4, SMEM_RESERVE + 4 * stage)
    return swap_plan(M, N, K, KT, experts=E)


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = ops.c_function("int8_matmul", "int8_matmul_launch",
                             [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p])
    return _FN


def _launch(x, w, dx, dw, out_dtype, name="int8_matmul"):
    """One launch for x (E, M, K) and w (E, N, K) (E = 1: the plain GEMM)."""
    E, M, K = x.shape
    N = w.shape[1]
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel loads rows with TMA in 16-byte "
                         "units; x and w must be 16-byte aligned")
    out = torch.empty((E, M, N), dtype=out_dtype, device=x.device)
    plan = gemm_plan(M, N, K, E)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn()(x.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                       out.data_ptr(), out_dtype == torch.bfloat16, E, M, N, K,
                       plan.regime == "swap", plan.width, plan.tile_n, plan.cluster,
                       plan.stages, plan.smem, stream)
    ops.check("int8_matmul", err)
    ops.LAUNCHES[name] += 1
    return out


def int8_matmul(x_int8, w_nk, dx, dw, *, out_dtype=torch.bfloat16):
    """x̂ (M, K) int8, W (N, K) int8, Δx (M,) f32, Δw (N,) f32 →
    (M, N) ``out_dtype`` = float(x̂·Wᵀ) · Δx[m] · Δw[n]."""
    _check(x_int8, w_nk, dx, dw, out_dtype)
    return ops.dispatch(
        x_int8, lambda: int8_matmul_ref(x_int8, w_nk, dx, dw, out_dtype),
        lambda: _launch(x_int8[None], w_nk[None], dx, dw, out_dtype)[0])


def int8_matmul_batched(x_int8, w_enk, dx, dw, *, out_dtype=torch.bfloat16):
    """x̂ (E, C, K) int8, W (E, N, K) int8, Δx (E, C) f32, Δw (E, N) f32 →
    (E, C, N) ``out_dtype`` = float(x̂[e]·W[e]ᵀ) · Δx[e, c] · Δw[e, n]: every
    expert's GEMM in one launch (``int8_matmul_batched`` in the counts)."""
    if x_int8.dim() != 3 or w_enk.dim() != 3 or x_int8.shape[0] != w_enk.shape[0]:
        raise ValueError(f"int8_matmul_batched: need x (E, C, K) and w (E, N, K), got "
                         f"{tuple(x_int8.shape)} and {tuple(w_enk.shape)}")
    E, C, K = x_int8.shape
    N = w_enk.shape[1]
    if dx.shape != (E, C) or dw.shape != (E, N):
        raise ValueError(f"int8_matmul_batched: dx must be {(E, C)} and dw {(E, N)}, "
                         f"got {tuple(dx.shape)}, {tuple(dw.shape)}")
    if not all(t.is_contiguous() for t in (x_int8, w_enk, dx, dw)):
        raise ValueError("int8_matmul_batched: inputs must be contiguous (w is "
                         "(E, N, K), K contiguous)")
    _check(x_int8.view(E * C, K), w_enk.view(E * N, w_enk.shape[2]), dx.view(-1),
           dw.view(-1), out_dtype)
    return ops.dispatch(
        x_int8, lambda: int8_matmul_batched_ref(x_int8, w_enk, dx, dw, out_dtype),
        lambda: _launch(x_int8, w_enk, dx, dw, out_dtype, "int8_matmul_batched"))
