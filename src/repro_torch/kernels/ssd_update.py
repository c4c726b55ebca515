"""The SSD (Mamba2) state recurrence over a verify or decode window — the
sequential path of ``repro/models/ssm.py`` (``_ssd_sequential``, a
``lax.scan`` there, not a TPU kernel):

    a_t = exp(dt_t · (−A)),  h_t = a_t·h_{t−1} + (dt_t·x_t) ⊗ B_t,  y_t = h_t·C_t

``ssd_update`` checks its inputs, then runs :func:`ssd_update_ref` (the
token loop, the reference's order of operations) for CPU tensors and the
CUDA kernel (``csrc/ssd_update.cu``) for CUDA tensors.  Training reaches
it at T ≤ 16: on the card a call that needs a gradient launches the kernel
forward and takes ``ssd_update_ref``'s vector-Jacobian product backward
(``kernels/ops.dispatch_differentiable``).  On the card the
kernel's states are bit-equal to the plain version's (the same IEEE steps,
never contracted into an FMA); its y sums over N in another fixed order,
so y agrees to f32 rounding.  A row's y and states depend on neither the
window length nor the batch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops

STATE_SIZES = (16, 32, 64, 128, 256)   # N the kernel is instantiated for
ROWS = 16                              # rows of P per block (P must be a multiple)


def ssd_update_ref(x, Bm, Cm, dt, A, h0, collect_states: bool):
    """Plain version: x (B,T,H,P), Bm/Cm (B,T,N), dt (B,T,H), A (H,), h0
    (B,H,P,N), all f32 → (y (B,T,H,P), every state (B,T,H,P,N) if
    ``collect_states`` else the last (B,H,P,N))."""
    a = torch.exp(dt * (-A))                                          # (B,T,H)
    h, ys, hs = h0, [], []
    for t in range(x.shape[1]):
        h = (a[:, t, :, None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
        if collect_states:
            hs.append(h)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape)
    if collect_states:
        return y, (torch.stack(hs, dim=1) if hs else
                   h0.new_zeros((x.shape[0], 0) + tuple(h0.shape[1:])))
    return y, h


def _check(x, Bm, Cm, dt, A, h0) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_update: x must be (B, T, H, P), got {tuple(x.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"Bm": (B, T, N), "Cm": (B, T, N), "dt": (B, T, H), "A": (H,),
            "h0": (B, H, P, N)}
    for name, t in zip(want, (Bm, Cm, dt, A, h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_update: {name} must be {want[name]}, got {tuple(t.shape)}")
    tensors = (x, Bm, Cm, dt, A, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("ssd_update: inputs must be f32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_update: inputs must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_update: inputs are on different devices")
    if x.device.type == "cuda" and (N not in STATE_SIZES or P % ROWS):
        raise ValueError(f"ssd_update: the kernel takes N in {STATE_SIZES} and P a "
                         f"multiple of {ROWS}, got N {N}, P {P}")


def _launch(x, Bm, Cm, dt, A, h0, collect_states: bool):
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    states = torch.empty((B, T, H, P, N) if collect_states else (B, H, P, N),
                         dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ops.c_function("ssd_update", "ssd_update_launch", [p] * 8 + [i] * 6 + [p])
    err = fn(ops.ptr(x), ops.ptr(Bm), ops.ptr(Cm), ops.ptr(dt), ops.ptr(A), ops.ptr(h0),
             ops.ptr(y), ops.ptr(states), int(collect_states), B, T, H, P, N, ops.stream(x))
    ops.check("ssd_update", err)
    ops.LAUNCHES["ssd_update"] += 1
    return y, states


def ssd_update(x, Bm, Cm, dt, A, h0, collect_states: bool = False):
    """x (B,T,H,P), Bm/Cm (B,T,N), dt (B,T,H), A (H,) (= exp(A_log) > 0),
    h0 (B,H,P,N), all f32 contiguous → (y (B,T,H,P), states (B,T,H,P,N)
    with ``collect_states`` else the last state (B,H,P,N))."""
    _check(x, Bm, Cm, dt, A, h0)
    return ops.dispatch_differentiable(
        lambda *t: ssd_update_ref(*t, collect_states),
        lambda *t: _launch(*t, collect_states), x, Bm, Cm, dt, A, h0)
