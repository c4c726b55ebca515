"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block — port of
``repro/models/ssm.py``.

Two execution paths share one parameterization:

* **chunked** (prefill, calibration; T > 16): the SSD algorithm — the
  quadratic attention-like intra-chunk term plus the inter-chunk
  recurrence over chunk states, as large einsums in plain PyTorch (the
  reference leaves them to XLA outside any kernel).
* **sequential** (decode / verify; T ≤ 16): the step recurrence
  ``h_t = a_t·h_{t-1} + (dt_t·x_t) ⊗ B_t`` through the ``ssd_update``
  wrapper (``kernels/ssd_update.py``: the CUDA kernel on the card, the
  token loop on the CPU), optionally keeping the state after *every*
  window token, so speculative decoding rolls back to the last accepted
  token by a gather.

Cache per layer: ``{"state": (B, H, P, N) f32, "conv": (B, 3, di + 2N)}``,
the SSD state and the depthwise conv's tail window, both **updated in
place** (``copy_``): a decode step captured as a CUDA graph replays into the
same tensors (``serving/graphs.py``).  A verify window (``collect_states``)
returns a *candidate* ``{"state", "conv", "states_all" (B, T, H, P, N),
"xbc_pad" (B, T + 3, di + 2N)}``: the layer's own tensors beside the
window's; :func:`commit_ssm_cache` gathers the accepted token's state and
conv tail into the former.

The in/out projections are quantizable linears (Quasar applies to them);
the conv, ``A_log``, ``D_skip``, ``dt_bias`` and both norms stay
unquantized (``quant/apply._EXCLUDE``), and the recurrent state stays f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_update import ssd_update
from repro_torch.models.common import Norm, rms_norm
from repro_torch.models.ffn import apply_linear
from repro_torch.models.linear import Linear

D_CONV = 4            # depthwise conv width
SEQUENTIAL_MAX = 16   # the longest window that takes the sequential path


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(−|x|)) (``F.softplus`` switches to x above 20 instead).  The
    CPU's exp and log1p are torch's, not XLA's, so values agree with the
    reference's within 3 ulp rather than bit for bit
    (``tests/test_torch_ssm.py::test_softplus_matches_jax``)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def init_ssm_cache(cfg, batch: int, device) -> dict:
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {"state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, D_CONV - 1, di + 2 * N), dtype=cfg.dtype,
                                device=device)}


def ssd_chunked(x, Bm, Cm, dt, A, h0, chunk: int):
    """SSD chunked algorithm, all f32: x (B,T,H,P), Bm/Cm (B,T,N), dt
    (B,T,H), A (H,), h0 (B,H,P,N) → (y (B,T,H,P), h_T)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    Tp = -(-T // Q) * Q
    if Tp != T:   # pad: dt = 0 ⇒ a = 1, x = 0 ⇒ the state is untouched
        pad = Tp - T
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = Tp // Q
    xc = x.reshape(B, nc, Q, H, P)
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    cs = torch.cumsum(dtc * (-A), dim=2)                                  # ℓ_t (inclusive)

    # intra-chunk (quadratic, attention-like).  Above the diagonal ℓ_t − ℓ_s
    # > 0 overflows exp once a chunk's Σ dt·A passes ~88, and the reference's
    # where(tri, exp(decay), 0) then has a NaN gradient (0 · ∞); exp of the
    # masked decay gives the same values and a finite gradient
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]                   # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    att = torch.where(tri, torch.exp(torch.where(tri, decay, 0.0)), 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    w = att * cb[..., None] * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w, xc)

    # chunk states, then the inter-chunk recurrence
    last = cs[:, :, -1:, :]
    S = torch.einsum("bcqh,bcqhp,bcqn->bchpn", torch.exp(last - cs) * dtc, xc, Bc)
    a_chunk = torch.exp(last[:, :, 0, :])                                 # (B,nc,H)
    h, before = h0, []
    for c in range(nc):
        before.append(h)                                                  # state before chunk c
        h = a_chunk[:, c, :, None, None] * h + S[:, c]
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(cs), Cc,
                           torch.stack(before, dim=1))
    y = (y_intra + y_inter).reshape(B, Tp, H, P)[:, :T]
    return y, h


class SSM(nn.Module):
    """The Mamba2 mixer: submodule and buffer paths ``in_proj``,
    ``out_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D_skip``,
    ``dt_bias`` and ``norm/scale``, the reference's."""

    def __init__(self, cfg, in_proj: nn.Module, out_proj: nn.Module, conv_w, conv_b,
                 A_log, D_skip, dt_bias, norm: Norm):
        super().__init__()
        self.cfg = cfg
        self.in_proj, self.out_proj, self.norm = in_proj, out_proj, norm
        for name, t in (("conv_w", conv_w), ("conv_b", conv_b), ("A_log", A_log),
                        ("D_skip", D_skip), ("dt_bias", dt_bias)):
            self.register_buffer(name, t)

    @classmethod
    def init(cls, generator, cfg, device):
        D, di, N, H, dt = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.dtype
        conv_dim = di + 2 * N
        in_proj = Linear.init(generator, D, 2 * di + 2 * N + H, False, dt, device)
        out_proj = Linear.init(generator, di, D, False, dt, device)
        conv_w = torch.randn((D_CONV, conv_dim), generator=generator, dtype=torch.float32,
                             device=device) * 0.2
        f32 = dict(dtype=torch.float32, device=device)
        return cls(cfg, in_proj, out_proj, conv_w.to(dt),
                   torch.zeros(conv_dim, dtype=dt, device=device),
                   torch.log(torch.linspace(1.0, 16.0, H, **f32)),
                   torch.ones(H, **f32),
                   torch.log(torch.expm1(torch.full((H,), 0.01, **f32))),   # softplus⁻¹
                   Norm(cfg, di, device))

    def readers(self) -> tuple:
        """The linears that read the block's input (its pre-norm's readers)."""
        return (self.in_proj,)

    def preprocess(self, u, conv_state, collect, path):
        """The shared projections: ``u`` (B, T, D) (or its norm's
        ``NormedCodes``) → (z, x (B,T,H,P), Bm, Cm (B,T,N) f32, dt (B,T,H)
        f32, xBC_pad (B, T+3, di+2N))."""
        cfg = self.cfg
        B, T = u.shape[0], u.shape[1]
        di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        zxbcdt = apply_linear(self.in_proj, u, collect, f"{path}/in_proj")
        z = zxbcdt[..., :di]
        xBC = zxbcdt[..., di:2 * di + 2 * N]
        dt_raw = zxbcdt[..., 2 * di + 2 * N:].float()
        if conv_state is None:
            conv_state = torch.zeros((B, D_CONV - 1, di + 2 * N), dtype=xBC.dtype,
                                     device=xBC.device)
        xBC_pad = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)      # (B, T+3, C)
        # the causal depthwise conv of width 4, summed left to right in f32
        w = self.conv_w.float()
        conv = xBC_pad[:, 0:T].float() * w[0]
        for i in range(1, D_CONV):
            conv = conv + xBC_pad[:, i:i + T].float() * w[i]
        xBC_c = F.silu(conv + self.conv_b.float()).to(u.dtype)
        x = xBC_c[..., :di].reshape(B, T, H, P)
        Bm = xBC_c[..., di:di + N].float()
        Cm = xBC_c[..., di + N:].float()
        dt = softplus(dt_raw + self.dt_bias)
        return z, x, Bm, Cm, dt, xBC_pad

    def forward(self, u, cache: Optional[dict] = None, *, collect_states: bool = False,
                collect=None, path: str = ""):
        """u (B, T, D) (or ``NormedCodes``) → (out (B, T, D), cache): the
        layer's cache updated in place, the verify candidate with
        ``collect_states``, or None without a cache."""
        cfg = self.cfg
        B, T = u.shape[0], u.shape[1]
        di = cfg.d_inner
        if collect_states and T > SEQUENTIAL_MAX:
            raise ValueError("collect_states requires the sequential path (T<=16)")
        conv_state = cache["conv"] if cache is not None else None
        h0 = cache["state"] if cache is not None else torch.zeros(
            (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
            device=u.device)
        z, x, Bm, Cm, dt, xBC_pad = self.preprocess(u, conv_state, collect, path)
        A = torch.exp(self.A_log)                                         # (H,) > 0
        xf = x.float()
        if T <= SEQUENTIAL_MAX:
            y, states = ssd_update(xf.contiguous(), Bm.contiguous(), Cm.contiguous(),
                                   dt.contiguous(), A, h0, collect_states)
        else:
            y, states = ssd_chunked(xf, Bm, Cm, dt, A, h0, cfg.ssm_chunk)

        y = y + self.D_skip[None, None, :, None] * xf                     # skip connection
        # the gated RMSNorm: row_mean's order on the card, whatever the rows
        y = rms_norm(y.reshape(B, T, di).to(u.dtype), self.norm.scale, cfg.norm_eps)
        y = y * F.silu(z.float()).to(y.dtype)
        out = apply_linear(self.out_proj, y, collect, f"{path}/out_proj")

        if cache is None:
            return out, None
        if collect_states:
            return out, {"state": cache["state"], "conv": cache["conv"],
                         "states_all": states, "xbc_pad": xBC_pad}
        cache["state"].copy_(states)
        cache["conv"].copy_(xBC_pad[:, -(D_CONV - 1):])
        return out, cache


def commit_ssm_cache(cand: dict, n_last: torch.Tensor) -> dict:
    """Resolve a verify candidate: keep the state after window token
    ``n_last`` (B,) (per row) and the conv tail ending at that token
    (window token t sits at slot t + 3 of ``xbc_pad``), gathered on the
    device with no host read and copied into the layer's own ``state`` and
    ``conv``, which are returned: a step captured as a graph must give back
    the tensors it was given."""
    B = n_last.shape[0]
    idx = n_last.long()
    state = cand["states_all"][torch.arange(B, device=idx.device), idx]  # (B,H,P,N)
    tail = idx[:, None] + 1 + torch.arange(D_CONV - 1, device=idx.device)[None, :]
    xbc = cand["xbc_pad"]
    conv = torch.gather(xbc, 1, tail[:, :, None].expand(B, D_CONV - 1, xbc.shape[-1]))
    cand["state"].copy_(state)
    cand["conv"].copy_(conv)
    return {"state": cand["state"], "conv": cand["conv"]}
