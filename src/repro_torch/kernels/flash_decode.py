"""Flash attention for the speculative verify/decode step over a contiguous
KV cache — port of the chain and tree variants of
``repro/kernels/flash_decode.py`` (bf16/f32 K/V, and int8 K/V with
per-(token, head) scales).

A short query window (T = 1…γ+1) attends the whole cache with
slot == position causality: key ``s`` is visible to the query at position
``p`` iff ``s <= p``.  A token-tree window (``tree_mask``, ``win_start``)
packs its T nodes at slots [win_start, win_start + T) while ``qpos`` is
``win_start + depth``; over those slots the (T, T) ancestor-or-self mask
decides instead, and slots past the window stay masked.  The kernel reads
the mask as bit words (``tree_bits``, ⌈T/32⌉ int32 per node), which
``core/tree.TreeTemplate`` builds once per device; a caller without them
gets them made from ``tree_mask``.

``flash_decode`` checks its inputs, then runs the plain version for CPU
tensors and the CUDA kernel (``csrc/flash_decode.cu``) for CUDA tensors.
Both accumulate in f32 but sum in different orders, so they agree to f32
rounding before the cast to ``q.dtype``.
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


def tree_override(valid, kpos, tree_mask, win_start) -> torch.Tensor:
    """Over a token-tree window's slots [win_start, win_start + T) the
    ancestor-or-self ``tree_mask`` (T, T) replaces the position mask
    ``valid`` (B, T, S); ``kpos`` (B, S) or (S,) are the slots' positions."""
    T = tree_mask.shape[0]
    rel = kpos.expand(valid.shape[0], valid.shape[-1]) - win_start[:, None]   # (B, S)
    in_win = (rel >= 0) & (rel < T)
    anc = tree_mask[:, rel.clamp(0, T - 1)].permute(1, 0, 2)                 # (B, T, S)
    return torch.where(in_win[:, None, :], anc, valid)


def visible(qpos, S: int, tree_mask=None, win_start=None) -> torch.Tensor:
    """(B, T, S) bool: slot ``s`` is visible to query row ``t`` (position
    causality; the ancestor mask over a tree window's slots)."""
    kpos = torch.arange(S, device=qpos.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]
    if tree_mask is not None:
        valid = tree_override(valid, kpos, tree_mask, win_start)
    return valid


def tree_mask_bits(tree_mask: torch.Tensor) -> torch.Tensor:
    """(T, T) bool → (T, ⌈T/32⌉) int32 bit words: bit ``j % 32`` of word
    ``j // 32`` of row ``i`` is ``tree_mask[i, j]``."""
    T = tree_mask.shape[0]
    W = -(-T // 32)
    m = torch.zeros((T, W * 32), dtype=torch.int64, device=tree_mask.device)
    m[:, :T] = tree_mask.long()
    words = (m.reshape(T, W, 32) << torch.arange(32, device=m.device)).sum(dim=2)
    return (words - ((words >> 31) << 32)).to(torch.int32)     # as signed 32-bit


def flash_decode_ref(q, k, v, qpos, k_scale=None, v_scale=None, tree_mask=None,
                     win_start=None):
    """Plain version, in the kernel's order of operations (flash_decode.py
    :100-114 of the reference) over one block holding the whole cache."""
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, G, dh)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * (dh ** -0.5)
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    valid = visible(qpos, S, tree_mask, win_start)[:, None, None]    # (B,1,1,T,S)
    s = torch.where(valid, s, MASK_VAL)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgts,bskh->bkgth", p, v.float()) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, dh).to(q.dtype)


def _check(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits) -> None:
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
    if (tree_mask is None) != (win_start is None):
        raise ValueError("flash_decode: tree_mask and win_start must be passed together")
    if tree_mask is not None:
        if tree_mask.shape != (T, T) or tree_mask.dtype != torch.bool:
            raise ValueError(f"flash_decode: tree_mask must be ({T}, {T}) bool, got "
                             f"{tuple(tree_mask.shape)} {tree_mask.dtype}")
        if win_start.shape != (B,) or win_start.dtype != torch.int32:
            raise ValueError(f"flash_decode: win_start must be ({B},) int32, got "
                             f"{tuple(win_start.shape)} {win_start.dtype}")
        if tree_bits is not None and (tree_bits.shape != (T, -(-T // 32))
                                      or tree_bits.dtype != torch.int32):
            raise ValueError(f"flash_decode: tree_bits must be ({T}, {-(-T // 32)}) "
                             f"int32, got {tuple(tree_bits.shape)} {tree_bits.dtype}")
    elif tree_bits is not None:
        raise ValueError("flash_decode: tree_bits is only read with tree_mask")
    tensors = [t for t in (q, k, v, qpos, k_scale, v_scale, tree_mask, win_start,
                           tree_bits) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: inputs must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_decode: inputs are on different devices")


def smem_bytes(rows: int, dh: int) -> int:
    """Dynamic shared memory of the kernel's split pass for ``rows`` query
    rows per block (layout in csrc/flash_decode.cu; rows pad to blocks of
    8)."""
    padded = -(-rows // ROW_BLOCK) * ROW_BLOCK
    floats = (2 * padded * dh + CHUNK * (2 * dh + 4) + padded * CHUNK + 4 * rows
              + 2 * CHUNK)
    return 4 * floats


def rows_per_block(rows: int, dh: int) -> int:
    """Query rows per block for ``rows`` = G·T rows of a KV head: all of
    them when two blocks still fit an SM's shared memory, else as few
    blocks as keep two per SM, with rows spread evenly in multiples of 8.
    (One block of a wide tree's rows per SM left 4 warps to hide the
    latency of every load.)"""
    budget = MAX_SMEM // 2
    if smem_bytes(rows, dh) <= budget:
        return rows
    cap = max(r for r in range(ROW_BLOCK, rows + 1, ROW_BLOCK)
              if smem_bytes(r, dh) <= budget)
    blocks = -(-rows // cap)
    return -(-(-(-rows // blocks)) // ROW_BLOCK) * ROW_BLOCK


def _launch(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits):
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    R = (Hq // Hkv) * T
    rpb = rows_per_block(R, dh)
    smem = smem_bytes(rpb, dh)
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
    tree = tree_mask is not None
    if tree and tree_bits is None:
        tree_bits = tree_mask_bits(tree_mask)
    fn = ops.c_function("flash_decode", "flash_decode_launch",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                        + [ctypes.c_int] * 11
                        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    err = fn(ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(k_scale), ops.ptr(v_scale),
             ops.ptr(qpos), ops.ptr(tree_bits), ops.ptr(win_start),
             -(-T // 32), ops.ptr(out), ops.ptr(part_m), ops.ptr(part_l),
             ops.ptr(part_acc), B, T, Hq, Hkv, S, dh, int(q.dtype == torch.bfloat16),
             int(int8), SPLIT_LEN, nsplit, rpb, smem, dh ** -0.5, ops.stream(q))
    ops.check("flash_decode", err)
    name = "flash_decode_tree" if tree else "flash_decode"
    ops.LAUNCHES[name + "_int8" if int8 else name] += 1
    return out


def flash_decode(q, k, v, qpos, *, k_scale=None, v_scale=None, tree_mask=None,
                 win_start=None, tree_bits=None):
    """q (B,T,Hq,dh), k/v (B,S,Hkv,dh) of q's dtype or int8 with k_scale /
    v_scale (B,S,Hkv) f32, qpos (B,T) int32 → (B,T,Hq,dh) in q's dtype.
    A token-tree window adds ``tree_mask`` (T,T) bool and ``win_start``
    (B,) int32 (and optionally the mask's bit words ``tree_bits``)."""
    _check(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits)
    return ops.dispatch(
        q, lambda: flash_decode_ref(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start),
        lambda: _launch(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits))
