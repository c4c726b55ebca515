"""Flash attention for the speculative verify/decode step over a contiguous
KV cache — port of the chain variants of ``repro/kernels/flash_decode.py``
(bf16/f32 K/V, and int8 K/V with per-(token, head) scales).

A short query window (T = 1…γ+1) attends the whole cache with
slot == position causality: key ``s`` is visible to the query at position
``p`` iff ``s <= p``.  ``flash_decode`` checks its inputs, then runs the
plain version for CPU tensors and the CUDA kernel
(``csrc/flash_decode.cu``) for CUDA tensors.  Both accumulate in f32 but
sum in different orders, so they agree to f32 rounding before the cast to
``q.dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops

MASK_VAL = -1e30
SPLIT_LEN = 128            # keys per block on the card: depends on S alone
CHUNK = 32                 # keys per shared-memory chunk in the kernel
ROW_BLOCK = 8              # query rows per register block in the kernel
HEAD_DIMS = (32, 64, 128)  # head sizes the kernel is instantiated for
MAX_SMEM = 232448          # bytes of shared memory a block may use (H100)


def flash_decode_ref(q, k, v, qpos, k_scale=None, v_scale=None):
    """Plain version, in the kernel's order of operations (flash_decode.py
    :100-114 of the reference) over one block holding the whole cache."""
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, G, dh)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * (dh ** -0.5)
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    kpos = torch.arange(S, device=q.device)
    valid = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]  # (B,1,1,T,S)
    s = torch.where(valid, s, MASK_VAL)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgts,bskh->bkgth", p, v.float()) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, dh).to(q.dtype)


def _check(q, k, v, qpos, k_scale, v_scale) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: need q (B,T,Hq,dh) and k, v (B,S,Hkv,dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hq, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or Hq % k.shape[2]:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_decode: q must be bf16/f32, got {q.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: k_scale and v_scale must be passed together")
    if k.dtype == torch.int8 or v.dtype == torch.int8:
        if k.dtype != v.dtype or k_scale is None:
            raise ValueError("flash_decode: int8 K/V need both k_scale and v_scale")
        for sc in (k_scale, v_scale):
            if sc.shape != k.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(f"flash_decode: scales must be {tuple(k.shape[:3])} "
                                 f"f32, got {tuple(sc.shape)} {sc.dtype}")
    elif k_scale is not None:
        raise ValueError("flash_decode: scales are only read with int8 K/V")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: K/V dtype {k.dtype} must be int8 or "
                         f"q's dtype {q.dtype}")
    if qpos.shape != (B, T) or qpos.dtype != torch.int32:
        raise ValueError(f"flash_decode: qpos must be ({B}, {T}) int32, got "
                         f"{tuple(qpos.shape)} {qpos.dtype}")
    tensors = [t for t in (q, k, v, qpos, k_scale, v_scale) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: inputs must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_decode: inputs are on different devices")


def smem_bytes(rows: int, dh: int) -> int:
    """Dynamic shared memory of the kernel's split pass for ``rows`` = G·T
    query rows (layout in csrc/flash_decode.cu; rows pad to blocks of 8)."""
    padded = -(-rows // ROW_BLOCK) * ROW_BLOCK
    floats = (2 * padded * dh + CHUNK * (2 * dh + 4) + padded * CHUNK + 4 * rows
              + 2 * CHUNK)
    return 4 * floats


def _launch(q, k, v, qpos, k_scale, v_scale):
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    R = (Hq // Hkv) * T
    smem = smem_bytes(R, dh)
    if smem > MAX_SMEM:
        raise ValueError(f"flash_decode: {R} query rows per KV head need {smem} "
                         f"bytes of shared memory, over {MAX_SMEM}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: the kernel loads K/V in 16-byte vectors; "
                         "k and v must be 16-byte aligned")
    int8 = k.dtype == torch.int8
    nsplit = -(-S // SPLIT_LEN)
    out = torch.empty_like(q)
    part_m = torch.empty((B * Hkv * nsplit * R,), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * Hkv * nsplit * R * dh,), dtype=torch.float32,
                           device=q.device)
    fn = ops.c_function("flash_decode", "flash_decode_launch",
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    err = fn(ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(k_scale), ops.ptr(v_scale),
             ops.ptr(qpos), ops.ptr(out), ops.ptr(part_m), ops.ptr(part_l),
             ops.ptr(part_acc), B, T, Hq, Hkv, S, dh, int(q.dtype == torch.bfloat16),
             int(int8), SPLIT_LEN, nsplit, smem, dh ** -0.5, ops.stream(q))
    ops.check("flash_decode", err)
    ops.LAUNCHES["flash_decode_int8" if int8 else "flash_decode"] += 1
    return out


def flash_decode(q, k, v, qpos, *, k_scale=None, v_scale=None):
    """q (B,T,Hq,dh), k/v (B,S,Hkv,dh) of q's dtype or int8 with k_scale /
    v_scale (B,S,Hkv) f32, qpos (B,T) int32 → (B,T,Hq,dh) in q's dtype."""
    _check(q, k, v, qpos, k_scale, v_scale)
    return ops.dispatch(q, lambda: flash_decode_ref(q, k, v, qpos, k_scale, v_scale),
                        lambda: _launch(q, k, v, qpos, k_scale, v_scale))
