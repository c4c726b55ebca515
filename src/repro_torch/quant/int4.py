"""W4A8: 4-bit weights for the verifier (paper §6, "Ultra-low Bit
Verification") — port of ``repro/quant/int4.py``.

Weights are symmetric-quantized to [-7, 7] per output channel and packed
two nibbles per int8 byte along the input dim (low nibble row 2r, high
nibble row 2r+1, both two's complement), so the verify pass streams 0.5
byte per weight, half of W8A8's.  Activations stay int8 (the smooth_quant
path); the GEMM unpacks the nibbles in registers (``csrc/int4_matmul.cu``).

``pack_int4`` / ``unpack_int4`` keep the reference's layout (packed along
dim 0).  :class:`~repro_torch.models.linear.W4A8Linear` stores the packed
weight transposed, **(dout, din/2) = (N, K/2), K contiguous**, for the same
reason ``W8A8Linear`` stores (N, K); it is transposed once, here and in the
bridge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.int4_matmul import unpack_nk
from repro_torch.kernels.ops import w4a8_matmul  # noqa: F401  (the W4A8 linear)
from repro_torch.kernels.smooth_quant import EPS
from repro_torch.models.linear import Linear, W4A8Linear

INT4_MAX = 7.0


def quantize_symmetric_int4(x: torch.Tensor, dim: int):
    """Returns (q int8 in [-7, 7], scale reduced over ``dim``) — the
    unpacked representation.  Divides exactly, as the reference's eager
    weight preparation does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=dim)
    scale = amax.clamp_min(EPS) / torch.full((), INT4_MAX, device=x.device)
    q = torch.round(x32 / scale.unsqueeze(dim)).clamp(-INT4_MAX, INT4_MAX)
    return q.to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(din, dout) int8 in [-7, 7] → (din/2, dout) packed (low | high << 4)."""
    if q.shape[0] % 2:
        raise ValueError(f"pack_int4: din={q.shape[0]} must be even")
    lo = q[0::2].to(torch.int32) & 0xF
    hi = (q[1::2].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (din/2, dout) → (din, dout) int8 in
    [-7, 7], sign-extended by arithmetic shifts."""
    return unpack_nk(packed.T).T


def quantize_linear_w4(p: Linear, smooth: torch.Tensor) -> W4A8Linear:
    """Smooth (``W·diag(s)^-1``), quantize to int4 per output channel, pack
    along din and store transposed: ``w_int4`` (dout, din/2)."""
    w = p.w.float() / smooth[:, None]
    q, scale = quantize_symmetric_int4(w, dim=0)      # Δw per out-channel (dout,)
    return W4A8Linear(pack_int4(q).T.contiguous(), scale, smooth.float(), p.b)
