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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``), f32 params."""

    def __init__(self, cfg, d: int, device=None):
        super().__init__()
        self.eps = cfg.norm_eps
        self.register_buffer("scale", torch.ones(d, dtype=torch.float32, device=device))
        if cfg.norm == "layernorm":
            self.register_buffer("bias", torch.zeros(d, dtype=torch.float32, device=device))
        else:
            self.bias = None

    def forward(self, x):
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
