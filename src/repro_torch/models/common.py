"""Shared building blocks: norms, RoPE, activations, initializers — port of
``repro/models/common.py``."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import smooth_quant as sq

_LIBM = None


def powf(x, y) -> np.ndarray:
    """Elementwise f32 ``x ** y`` (numpy broadcasting) through the C
    library's ``powf``.

    The reference's ``jnp.power`` on the CPU lowers to libm ``powf``;
    torch's and numpy's f32 ``pow`` differ from it in the last bit for some
    inputs.  Computed on the host, for the short vectors it is used on
    (RoPE frequencies, SmoothQuant factors), so the port's values are
    bit-identical to the reference's.
    """
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.powf.argtypes, lib.powf.restype = [ctypes.c_float, ctypes.c_float], ctypes.c_float
        _LIBM = lib
    xb, yb = np.broadcast_arrays(np.asarray(x, np.float32), np.asarray(y, np.float32))
    out = np.fromiter((_LIBM.powf(float(a), float(b))
                       for a, b in zip(xb.reshape(-1), yb.reshape(-1))),
                      np.float32, xb.size)
    return out.reshape(xb.shape)


FOLD = 32    # widest last axis whose CUDA reduction layout ignores the row count


def row_mean(x32: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, keepdim, with each row's sum taken in an
    order that does not depend on how many rows there are.

    On a card, torch's reduction picks its thread layout from the number of
    rows (``setReduceConfig``: a 4096-wide row is summed by 128 threads at
    4 rows and by 32 at 24), so a row's bits would depend on the batch and
    window it came in, and greedy speculative decoding, whose verify window
    has γ+1 times vanilla's rows, could leave vanilla's tokens.  Summing in
    steps over a last axis of at most 32 (zero-padded; +0 is exact) gives
    every step one layout for any row count (held by the card test
    ``test_norm_row_does_not_depend_on_row_count``).

    The CPU keeps torch's mean, whose rows are already row-invariant there
    (``tests/test_torch_model.py::test_norm_row_does_not_depend_on_row_count_on_cpu``):
    its order matches the reference's to the f32 rounding that the CPU tests
    hold, and the fold's order does not (with the fold on the CPU,
    ``tests/test_torch_model.py::test_forward_logits_match_jax[f32-True-0.0001]``
    and ``test_prefill_verify_match_jax[False-int8]`` fail: a changed
    rounding flips int8 codes downstream).  On the card an RMSNorm read by
    quantized linears runs as one ``norm_smooth_quant`` kernel instead, one
    block per row and so row-invariant by construction (:class:`Norm`);
    this fold serves the other norms there (LayerNorm, the bf16 verifier,
    calibration, a tied ``lm_head``)."""
    if x32.device.type != "cuda":
        return x32.mean(dim=-1, keepdim=True)
    s, d = x32, x32.shape[-1]
    while s.shape[-1] > FOLD:
        if s.shape[-1] % FOLD:
            s = F.pad(s, (0, -s.shape[-1] % FOLD))
        s = s.view(*s.shape[:-1], -1, FOLD).sum(dim=-1)
    return s.sum(dim=-1, keepdim=True) / d


def fixed_rows_matmul(x32: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """(n, D) × (D, E) of one dtype (f32; bf16 for ``models/linear.Linear``)
    → (n, E).  On the card in zero-padded
    chunks of ``rows`` rows, each the same GEMM shape, so a row's result
    depends neither on n nor on where the row sits (cuBLAS picks its kernel,
    and with it the reduction order, from M); the CPU takes one product."""
    if x32.device.type != "cuda":
        return x32 @ w
    n = x32.shape[0]
    x32 = F.pad(x32, (0, 0, 0, -n % rows))
    return torch.cat([c @ w for c in x32.split(rows)])[:n]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = row_mean(x32.square())
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = row_mean(x32)
    var = row_mean((x32 - mu).square())
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class NormedCodes:
    """What a fused RMSNorm hands the quantized linears that read it: for
    each, its int8 codes and Δx ``(x̂ (M, D), Δx (M,))``, made by one
    ``norm_smooth_quant`` launch; the normed activations themselves are
    never written.  ``shape``, ``dtype`` and ``device`` are those of the
    norm's input."""

    def __init__(self, x: torch.Tensor, codes: dict):
        self.shape, self.dtype, self.device, self._codes = x.shape, x.dtype, x.device, codes

    def apply(self, lin: nn.Module) -> torch.Tensor:
        """``lin``'s output, from the codes made with its ``smooth``."""
        xq, dx = self._codes[id(lin)]
        return lin.forward_quantized(xq, dx, self.shape[:-1], self.dtype)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``), f32 params.

    ``readers``: the linears that read this norm's output.  On the card, an
    RMSNorm whose readers are all quantized (``forward_quantized``) returns
    :class:`NormedCodes` from one ``norm_smooth_quant`` launch: the norm,
    then each reader's smoothing and int8 quantization.  Every other case
    (the CPU, LayerNorm, bf16 readers, calibration, which passes no
    readers) computes the norm as the reference composes it and returns the
    normed tensor.  The choice follows the device and the configuration,
    never a failure."""

    def __init__(self, cfg, d: int, device=None):
        super().__init__()
        self.eps = cfg.norm_eps
        self.register_buffer("scale", torch.ones(d, dtype=torch.float32, device=device))
        if cfg.norm == "layernorm":
            self.register_buffer("bias", torch.zeros(d, dtype=torch.float32, device=device))
        else:
            self.bias = None

    def fuses(self, x: torch.Tensor, readers) -> bool:
        return (x.device.type == "cuda" and self.bias is None and len(readers) > 0
                and all(hasattr(r, "forward_quantized") for r in readers)
                and x.dtype in (torch.bfloat16, torch.float32)
                and x.shape[-1] <= sq.max_width(x.dtype))

    def forward(self, x, readers=()):
        if self.fuses(x, readers):
            outs = sq.norm_smooth_quant(x.reshape(-1, x.shape[-1]).contiguous(), self.scale,
                                        self.eps, [r.smooth for r in readers])
            return NormedCodes(x, {id(r): o for r, o in zip(readers, outs)})
        if self.bias is not None:
            return layer_norm(x, self.scale, self.bias, self.eps)
        return rms_norm(x, self.scale, self.eps)


def activation(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(Dh/2,) f32 inverse frequencies 1 / theta^(2i/Dh)."""
    expo = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    return torch.from_numpy(np.float32(1.0) / powf(theta, expo)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh), positions: (B, T) int32.  Half-split rotation:
    the first and second halves of each head are the pair's two parts."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)                 # (Dh/2,)
    angles = positions.float()[..., None] * freqs                 # (B, T, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (the reference's distributions; torch's generator draws
# other numbers from the same seed)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype, device, in_axis: int = -2):
    std = shape[in_axis] ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)
