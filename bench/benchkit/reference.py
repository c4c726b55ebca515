"""The plain reference of a dense decoder (a configuration names it under
``reference``): its raw weights' layout, and its forward in float32, plain
PyTorch, from the benchmark's raw weights and token ids alone.

It imports nothing of the program.  It works the W8A8 verification out
again from the raw weights: the smoothing factors (no calibration
statistics, so s = 1 by the m2 rule), each linear's int8 codes with one
scale per output channel, each row's int8 activation codes with one scale
per row, the product of the codes and both scales.  The embedding and the
norms stay unquantized.  Everything else runs in float32 with TF32 off:
RMSNorm, RoPE by half-split rotation, causal grouped-query attention,
SiLU-gated FFN.

It runs layer by layer over all the sequences, dequantizing one layer's
weights at a time, so it fits beside the raw weights.  ``lm_head`` is
applied only at the positions asked for.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

INT8_MAX = 127.0
EPS = 1e-8


def layout(model: dict) -> List[Tuple[str, tuple, torch.dtype, float]]:
    """(name, shape, dtype, std) of every raw weight; std 0 marks a norm
    scale (ones).  Names follow the program's parameter paths; a linear's
    ``w`` is (din, dout).  The distributions are the program's initialisers:
    a linear N(0, din^-1/2), the embedding N(0, 0.02), norm scales 1."""
    dt = getattr(torch, model.get("dtype", "bfloat16"))
    D, L, V, F = model["d_model"], model["num_layers"], model["vocab_size"], model["d_ff"]
    hd = model.get("head_dim") or D // model["num_heads"]
    q, kv = model["num_heads"] * hd, model["num_kv_heads"] * hd
    out = [("embed/w", (V, D), dt, 0.02)]
    for i in range(L):
        p = f"layers/{i}/"
        out += [(p + "attn_norm/scale", (D,), torch.float32, 0.0),
                (p + "attn/q/w", (D, q), dt, D ** -0.5),
                (p + "attn/k/w", (D, kv), dt, D ** -0.5),
                (p + "attn/v/w", (D, kv), dt, D ** -0.5),
                (p + "attn/o/w", (q, D), dt, q ** -0.5),
                (p + "ffn_norm/scale", (D,), torch.float32, 0.0),
                (p + "ffn/gate/w", (D, F), dt, D ** -0.5),
                (p + "ffn/up/w", (D, F), dt, D ** -0.5),
                (p + "ffn/down/w", (F, D), dt, F ** -0.5)]
    return out + [("final_norm/scale", (D,), torch.float32, 0.0),
                  ("lm_head/w", (D, V), dt, D ** -0.5)]


def quantize_weight(w: torch.Tensor) -> torch.Tensor:
    """(din, dout) → the dequantized W8A8 weight in float32: int8 codes
    with one symmetric scale per output channel."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(EPS) / INT8_MAX
    return torch.round(w / scale).clamp(-INT8_MAX, INT8_MAX) * scale


def quantize_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 activation codes, dequantized (float32)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(EPS) / INT8_MAX
    return torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX) * scale


def linear(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    return quantize_rows(x) @ wq


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, dh) at positions 0 … T-1, half-split rotation."""
    T, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, lw: Dict[str, torch.Tensor], m: dict) -> torch.Tensor:
    T = x.shape[0]
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    dh = m.get("head_dim") or m["d_model"] // H
    q = rope(linear(x, lw["q"]).view(T, H, dh), m["rope_theta"])
    k = rope(linear(x, lw["k"]).view(T, Hkv, dh), m["rope_theta"])
    v = linear(x, lw["v"]).view(T, Hkv, dh)
    g = H // Hkv
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hts,shd->thd", p, v).reshape(T, H * dh)
    return linear(o, lw["o"])


def ffn(x: torch.Tensor, lw: Dict[str, torch.Tensor]) -> torch.Tensor:
    return linear(torch.nn.functional.silu(linear(x, lw["gate"])) * linear(x, lw["up"]),
                  lw["down"])


@torch.no_grad()
def logits(model: dict, weights: Dict[str, torch.Tensor], seqs: Sequence[torch.Tensor],
           starts: Sequence[int]) -> List[torch.Tensor]:
    """For each token sequence (1-D, int64), the float32 logits at the
    positions ``start`` … T-2 (the predictions of tokens ``start + 1`` …
    T-1), one (T-1-start, V) tensor per sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = model["norm_eps"]
    xs = [weights["embed/w"][s].float() for s in seqs]
    for i in range(model["num_layers"]):
        p = f"layers/{i}/"
        lw = {n: quantize_weight(weights[p + f"attn/{n}/w"]) for n in "qkvo"}
        xs = [x + attention(rms_norm(x, weights[p + "attn_norm/scale"], eps), lw, model)
              for x in xs]
        lw = {n: quantize_weight(weights[p + f"ffn/{n}/w"]) for n in ("gate", "up", "down")}
        xs = [x + ffn(rms_norm(x, weights[p + "ffn_norm/scale"], eps), lw) for x in xs]
        del lw
    head = quantize_weight(weights["lm_head/w"])
    out = [linear(rms_norm(x[s:-1], weights["final_norm/scale"], eps), head)
           for x, s in zip(xs, starts)]
    return out
