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

A **ring** cache (the sliding window, ``models/attention.py``) passes
``kpos`` (B, S) int32, each slot's absolute position, and ``window``: key
``s`` of row ``b`` is visible to the query at position ``p`` iff
``0 <= p - kpos[b, s] < window`` (an unwritten slot holds ``-2^30``, so
``p - kpos`` is at least 2^30 and the slot is masked).  The reference
reads a ring through plain jnp, not its Pallas kernel; the port reads it
here so that on the card a row's bits depend on neither T nor B (with
bf16 queries through a body of its own: splits and key slices from S
alone, chunks no query row sees skipped, the splits merged in the same
launch through :func:`merge_counters`).  Token trees do not compose with a
ring (the reference refuses them).

``flash_decode_cross`` is the cross-attention read: every one of the S
keys is visible to every query, so it takes no positions; on the card, bf16
queries run the sliced body of the ring read without its positions (splits
from S alone, :func:`cross_split_len`; one launch that merges its splits).

``flash_decode`` checks its inputs, then runs the plain version for CPU
tensors and the CUDA kernel (``csrc/flash_decode.cu``) for CUDA tensors.
Both accumulate in f32 but sum in different orders, so they agree to f32
rounding before the cast to ``q.dtype``.

``flash_decode_paged`` is the same attention over a **paged** cache —
port of the reference's ``flash_decode_paged``: K/V (and the int8 scales)
live in physical pools ``(N, bs, Hkv, dh)`` and a ``(B, nb)`` int32 block
table maps logical block ``s // bs`` of row ``b`` to its pool block.  Its
plain version gathers the logical view (``core/paged_cache.
gather_block_rows``) and runs :func:`flash_decode_ref`; its kernel reads
the pools through the table and gives the contiguous kernel's bits for
the same logical content.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.paged_cache import gather_block_rows
from repro_torch.kernels import ops

MASK_VAL = -1e30
SPLIT_LEN = 128            # keys per block on the card: depends on S alone
CHUNK = 32                 # keys per online-softmax step (a copy group of the ring)
RING = 3                   # K/V chunks staged at once in the tensor-core body
TILE = 16                  # query rows per warp in the tensor-core body
MMA_ROWS = 128             # most query rows per block in the tensor-core body
RING_SLICES = 4            # key slices per split in the ring body: one warp per (tile, slice)
RING_ROWS = 32             # most query rows per block in the ring body (two tiles)
RING_CHUNK = 16            # keys per online-softmax step in the ring body
RING_STAGES = 3            # chunk slots per key slice in the ring body (two in flight)
RING_MAX_SPLIT = 512       # most keys per split in the ring body (128 per slice)
RING_SPLITS = 16           # splits of a long ring in the ring body (B·Hkv·16 blocks)
CROSS_SPLITS = 4           # splits of a long cross read (B 4 fills the SMs in one round)
CROSS_MIN_SPLIT = 128      # fewest keys per split of the cross read
CROSS_ROWS = 64            # most query rows per block of the cross read (32 at dh 160)
HEAD_DIMS = (32, 64, 80, 128, 160)  # head sizes the kernel is instantiated for
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


def visible(qpos, S: int, tree_mask=None, win_start=None, kpos=None,
            window=None) -> torch.Tensor:
    """(B, T, S) bool: slot ``s`` is visible to query row ``t`` (position
    causality; the ancestor mask over a tree window's slots; over a ring,
    ``0 <= qpos - kpos < window``)."""
    if kpos is not None:
        d = qpos[:, :, None] - kpos[:, None, :]
        return (d >= 0) & (d < window)
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
                     win_start=None, kpos=None, window=None):
    """Plain version, in the kernel's order of operations (flash_decode.py
    :100-114 of the reference) over one block holding the whole cache."""
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, G, dh)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * (dh ** -0.5)
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    valid = visible(qpos, S, tree_mask, win_start, kpos, window)[:, None, None]  # (B,1,1,T,S)
    s = torch.where(valid, s, MASK_VAL)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgts,bskh->bkgth", p, v.float()) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, dh).to(q.dtype)


def flash_decode_paged_ref(q, k, v, bt, qpos, k_scale=None, v_scale=None,
                           tree_mask=None, win_start=None):
    """Plain version of :func:`flash_decode_paged`: gather the logical
    ``(B, nb·bs, ...)`` view through the block table, then
    :func:`flash_decode_ref` (the reference's paged oracle)."""
    gather = lambda pool: None if pool is None else gather_block_rows(pool, bt)  # noqa: E731
    return flash_decode_ref(q, gather(k), gather(v), qpos, gather(k_scale), gather(v_scale),
                            tree_mask, win_start)


def _check(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits,
           paged: bool = False, kpos=None, window=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: need q (B,T,Hq,dh) and k, v (B,S,Hkv,dh) "
                         f"or pools (N,bs,Hkv,dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hq, dh = q.shape
    if (not paged and k.shape[0] != B) or k.shape[3] != dh or Hq % k.shape[2]:
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
    if qpos is not None and (qpos.shape != (B, T) or qpos.dtype != torch.int32):
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
    if (kpos is None) != (window is None):
        raise ValueError("flash_decode: kpos and window must be passed together")
    if kpos is not None:
        if tree_mask is not None:
            raise ValueError("flash_decode: a ring (kpos) takes no token-tree window")
        if kpos.shape != (B, k.shape[1]) or kpos.dtype != torch.int32:
            raise ValueError(f"flash_decode: kpos must be ({B}, {k.shape[1]}) int32, got "
                             f"{tuple(kpos.shape)} {kpos.dtype}")
        if not 0 < int(window) < 2 ** 30:
            raise ValueError(f"flash_decode: window must be in [1, 2^30), got {window}")
    tensors = [t for t in (q, k, v, qpos, k_scale, v_scale, tree_mask, win_start,
                           tree_bits, kpos) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: inputs must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_decode: inputs are on different devices")


class Plan(NamedTuple):
    """How the split pass of ``csrc/flash_decode.cu`` is launched."""
    rows_per_block: int    # query rows per block: all G·T, or a multiple of 16
    smem: int              # dynamic shared bytes per block
    stages: int            # K/V chunks in flight per block (cp.async groups)
    nsplit: int            # splits of S: depends on S alone
    threads: int           # threads per block
    split_len: int = SPLIT_LEN  # keys per split: depends on S alone
    slices: int = 1        # key slices per split, one warp each per 16-row tile (ring body)


def _even_blocks(rows: int, cap: int) -> int:
    """Rows per block when ``rows`` exceed ``cap``: as few blocks as the cap
    allows, rows spread evenly in multiples of TILE."""
    blocks = -(-rows // cap)
    return -(-(-(-rows // blocks)) // TILE) * TILE


def ring_split_len(S: int) -> int:
    """Keys per split of the ring body, from S alone: whole RING_CHUNK-key
    chunks, as few as make RING_SPLITS splits, between 128 and
    RING_MAX_SPLIT keys.  A ring of 2048 slots or more then takes 16 splits
    (17 once a split would pass 512 keys): at B 1 and 8 KV heads 128 blocks
    for the 132 SMs, at B 4 512 blocks, two per SM in two rounds (17
    splits left 16 blocks to a third); and a long ring writes fewer f32
    partials (272 keys at the 7B's 4224 slots: 16 splits, not 128-key
    splits' 33)."""
    chunks = -(-S // RING_CHUNK)
    per_split = -(-chunks // RING_SPLITS)
    return RING_CHUNK * max(SPLIT_LEN // RING_CHUNK,
                            min(RING_MAX_SPLIT // RING_CHUNK, per_split))


def ring_smem(rows_per_block: int, dh: int, int8: bool) -> int:
    """Dynamic shared bytes of the ring body (``flash_sliced_kernel``):
    the block's query rows and the slices' stages
    (:func:`ring_slices_bytes`), which the fold and the merge reuse."""
    return -(-rows_per_block // TILE) * TILE * (2 * dh + 16) + ring_slices_bytes(dh, int8)


def ring_slices_bytes(dh: int, int8: bool) -> int:
    """The ring body's stage bytes (``SLICE`` in ``csrc/flash_decode.cu``)
    for all RING_SLICES slices: RING_STAGES chunks each of K and V rows
    and the chunk's positions (int8: and scales) and, for int8 K/V, one
    chunk widened to bf16."""
    brow = 2 * dh + 16
    krow = dh if int8 else brow
    stage = 2 * RING_CHUNK * krow + 4 * RING_CHUNK + (2 * 4 * RING_CHUNK if int8 else 0)
    return RING_SLICES * (RING_STAGES * stage + (2 * RING_CHUNK * brow if int8 else 0))


def cross_split_len(S: int) -> int:
    """Keys per split of the cross read's sliced body, from S alone: whole
    RING_CHUNK-key chunks dealt as evenly as they go to CROSS_SPLITS
    splits from 4·CROSS_MIN_SPLIT keys on (two from 2·CROSS_MIN_SPLIT, one
    below), and to more past 4·RING_MAX_SPLIT keys, so no split passes
    RING_MAX_SPLIT.  Whisper's 1500 frames: four splits of 384 keys;
    vision's 1600 image tokens: four of 400; at B 4 one round of 192 and
    128 blocks on the 132 SMs."""
    n = (CROSS_SPLITS if S >= CROSS_SPLITS * CROSS_MIN_SPLIT
         else 2 if S >= 2 * CROSS_MIN_SPLIT else 1)
    n = max(n, -(-S // RING_MAX_SPLIT))
    return RING_CHUNK * -(-(-(-S // RING_CHUNK)) // n)


def cross_smem(rows_per_block: int, dh: int, nsplit: int) -> int:
    """Dynamic shared bytes of the cross read's sliced body: the block's
    query rows, then the largest of the slices' stages (K and V rows of
    RING_STAGES chunks each), the fold (each slice's accumulators, rows
    dh + 8 floats apart, and its m, l and weight per row) and the merge
    (each split's m and l per row, and the denominators), which reuse the
    same bytes one after the other."""
    rp = -(-rows_per_block // TILE) * TILE
    brow = 2 * dh + 16
    stages = RING_SLICES * RING_STAGES * 2 * RING_CHUNK * brow
    fold = 4 * RING_SLICES * rp * (dh + 8 + 3)
    merge = 4 * (2 * nsplit + 1) * rp
    return rp * brow + max(stages, fold, merge)


def cross_plan(rows: int, S: int, dh: int) -> Plan:
    """The launch plan of the cross read with bf16 queries (``rows`` = G·T
    query rows per KV head over S keys): the sliced body, splits of
    :func:`cross_split_len` keys, RING_SLICES key slices, one warp per
    (16-row tile, slice), at most CROSS_ROWS rows per block (32 at dh 160,
    whose accumulators need the registers of half as many warps); wider
    windows spread over row blocks."""
    split = cross_split_len(S)
    cap = CROSS_ROWS if dh <= 128 else RING_ROWS
    rpb = rows if rows <= cap else _even_blocks(rows, cap)
    nsplit = -(-S // split)
    return Plan(rpb, cross_smem(rpb, dh, nsplit), RING_STAGES, nsplit,
                32 * RING_SLICES * -(-rpb // TILE), split, RING_SLICES)


def launch_plan(rows: int, S: int, dh: int, q_dtype: torch.dtype,
                kv_dtype: torch.dtype, ring: bool = False) -> Plan:
    """The launch plan for ``rows`` = G·T query rows per KV head over S
    cached keys (``ring``: a ring cache read through ``kpos``).

    A ring with bf16 queries takes the ring body: splits of
    :func:`ring_split_len` keys, each split's RING_CHUNK-key chunks dealt
    to RING_SLICES key slices that stream them through RING_STAGES stages
    each; one warp per (16-row tile, slice), at most RING_ROWS rows per
    block (wider windows spread over row blocks).

    bf16 queries take the tensor-core body: one block holds all rows up to
    MMA_ROWS (one warp per 16-row tile, at least 4 warps to run the
    copies) and stages K/V in their stored type in a ring of RING 32-key
    chunks (the next two in flight while one is used); wider windows spread
    over row blocks of at most MMA_ROWS rows.  f32 queries take the f32 body (8 warps, K/V
    widened to f32 one 32-key chunk at a time), with as many rows per block
    as keep two blocks on an SM."""
    nsplit = -(-S // SPLIT_LEN)
    if q_dtype == torch.bfloat16 and ring:
        split = ring_split_len(S)
        rpb = rows if rows <= RING_ROWS else _even_blocks(rows, RING_ROWS)
        ring_nsplit = -(-S // split)
        if 4 * (2 * ring_nsplit + 1) * RING_ROWS > ring_slices_bytes(dh, kv_dtype == torch.int8):
            raise ValueError(f"flash_decode: a ring of {S} slots needs {ring_nsplit} splits, "
                             "more than the ring body's merge holds")
        return Plan(rpb, ring_smem(rpb, dh, kv_dtype == torch.int8), RING_STAGES, ring_nsplit,
                    32 * RING_SLICES * -(-rpb // TILE), split, RING_SLICES)
    if q_dtype == torch.bfloat16:
        rpb = rows if rows <= MMA_ROWS else _even_blocks(rows, MMA_ROWS)
        tiles = -(-rpb // TILE)
        kv_bytes = 1 if kv_dtype == torch.int8 else 2
        smem = tiles * TILE * (2 * dh + 16) + RING * 2 * CHUNK * (dh * kv_bytes + 16)
        if kv_dtype == torch.int8:     # the ring's scales, one chunk widened to bf16
            smem += RING * 2 * 4 * CHUNK + 2 * CHUNK * (2 * dh + 16)
        return Plan(rpb, smem, RING, nsplit, 32 * max(4, tiles))

    def f32_smem(r: int) -> int:       # layout of flash_split_f32_kernel
        padded = -(-r // 8) * 8
        return 4 * (2 * padded * dh + CHUNK * (2 * dh + 4) + padded * CHUNK + 4 * r
                    + 2 * CHUNK)

    budget = MAX_SMEM // 2
    if f32_smem(rows) <= budget:
        rpb = rows
    else:
        cap = max(r for r in range(TILE, rows + 1, TILE) if f32_smem(r) <= budget)
        rpb = _even_blocks(rows, cap)
    return Plan(rpb, f32_smem(rpb), 1, nsplit, 256)


_MERGE_COUNTERS: dict = {}   # device → every counter buffer made there, the newest last


def merge_counters(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for the sliced body's merge
    (a ring or a cross read), one per (b, kv head, row block), shared by
    every such read on ``device``: the last block of each (b, kv head, row
    block) sets its counter back to 0, so the buffer is zero between
    launches and a CUDA graph replays a captured launch.  A buffer is made
    (or grown) outside a graph capture, and none is freed (a graph holds
    the pointer it captured); the reads on one card run on one stream at a
    time, as every launch of the port."""
    bufs = _MERGE_COUNTERS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: the merge counters must grow outside a "
                               "CUDA graph capture: run the step once eagerly first")
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=device))
    return bufs[-1]


def _check_table(q, k, bt) -> None:
    if bt.dim() != 2 or bt.shape[0] != q.shape[0] or bt.shape[1] < 1 \
            or bt.dtype != torch.int32:
        raise ValueError(f"flash_decode_paged: bt must be ({q.shape[0]}, nb >= 1) int32, "
                         f"got {tuple(bt.shape)} {bt.dtype}")
    if not bt.is_contiguous():
        raise ValueError("flash_decode_paged: inputs must be contiguous")
    if bt.device != q.device:
        raise ValueError("flash_decode_paged: inputs are on different devices")


def _scratch(q, k, v, n: int):
    """Check K/V's alignment; the output and the (part_m, part_l, part_acc)
    f32 scratch of ``n`` = B·Hkv·nsplit·R split rows."""
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: the kernel loads K/V in 16-byte vectors; "
                         "k and v must be 16-byte aligned")
    part_m = torch.empty((n,), dtype=torch.float32, device=q.device)
    return (torch.empty_like(q), part_m, torch.empty_like(part_m),
            torch.empty((n * q.shape[3],), dtype=torch.float32, device=q.device))


def _launch(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits, bt=None,
            kpos=None, window=None):
    """Launch the split and merge kernels on contiguous K/V (a ring with
    ``kpos``/``window``: with bf16 queries the ring body, which merges its
    splits itself), or on pools through the block table ``bt`` (logical
    length nb·bs)."""
    B, T, Hq, dh = q.shape
    paged = bt is not None
    S = bt.shape[1] * k.shape[1] if paged else k.shape[1]
    Hkv = k.shape[2]
    R = (Hq // Hkv) * T
    ring = kpos is not None
    plan = launch_plan(R, S, dh, q.dtype, k.dtype, ring=ring)
    int8 = k.dtype == torch.int8
    nsplit = plan.nsplit
    out, part_m, part_l, part_acc = _scratch(q, k, v, B * Hkv * nsplit * R)
    tree = tree_mask is not None
    if tree and tree_bits is None:
        tree_bits = tree_mask_bits(tree_mask)
    head = [int(q.dtype == torch.bfloat16), int(int8), nsplit]
    tail = [plan.rows_per_block, plan.threads, plan.smem, dh ** -0.5, ops.stream(q)]
    tail_types = [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    if paged:
        fn = ops.c_function("flash_decode", "flash_decode_paged_launch",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 8 + tail_types)
        err = fn(ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(k_scale), ops.ptr(v_scale),
                 ops.ptr(bt), bt.shape[1], k.shape[1], ops.ptr(qpos), ops.ptr(tree_bits),
                 ops.ptr(win_start), -(-T // 32), ops.ptr(out), ops.ptr(part_m),
                 ops.ptr(part_l), ops.ptr(part_acc), B, T, Hq, Hkv, dh, *head, *tail)
    else:
        counters = None
        if ring and q.dtype == torch.bfloat16:      # the ring body merges its splits itself
            counters = merge_counters(q.device, B * Hkv * -(-R // plan.rows_per_block))
        fn = ops.c_function("flash_decode", "flash_decode_launch",
                            [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p,
                                                     ctypes.c_int] + [ctypes.c_void_p] * 5
                            + [ctypes.c_int] * 10 + tail_types)
        err = fn(ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(k_scale), ops.ptr(v_scale),
                 ops.ptr(qpos), ops.ptr(tree_bits), ops.ptr(win_start),
                 -(-T // 32), ops.ptr(kpos), int(window or 0), ops.ptr(out), ops.ptr(part_m),
                 ops.ptr(part_l), ops.ptr(part_acc), ops.ptr(counters), B, T, Hq, Hkv, S, dh,
                 *head, plan.split_len, *tail)
    ops.check("flash_decode", err)
    ops.LAUNCHES["flash_decode" + "_paged" * paged + "_tree" * tree + "_ring" * ring
                 + "_int8" * int8] += 1
    return out


def _launch_cross(q, k, v):
    """The cross read's one launch (bf16: the sliced body, merging its
    splits itself) or, for f32 queries, the f32 body and the merge, with no
    positions."""
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    R = (Hq // Hkv) * T
    bf16 = q.dtype == torch.bfloat16
    plan = cross_plan(R, S, dh) if bf16 else launch_plan(R, S, dh, q.dtype, k.dtype)
    out, part_m, part_l, part_acc = _scratch(q, k, v, B * Hkv * plan.nsplit * R)
    counters = merge_counters(q.device, B * Hkv * -(-R // plan.rows_per_block)) if bf16 else None
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ops.c_function("flash_decode", "flash_decode_cross_launch",
                        [p] * 8 + [i] * 11 + [ctypes.c_longlong, ctypes.c_float, p])
    err = fn(ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(out), ops.ptr(part_m),
             ops.ptr(part_l), ops.ptr(part_acc), ops.ptr(counters), B, T, Hq, Hkv, S, dh,
             int(bf16), plan.nsplit, plan.split_len, plan.rows_per_block, plan.threads,
             plan.smem, dh ** -0.5, ops.stream(q))
    ops.check("flash_decode", err)
    ops.LAUNCHES["flash_decode_cross"] += 1
    return out


def flash_decode(q, k, v, qpos, *, k_scale=None, v_scale=None, tree_mask=None,
                 win_start=None, tree_bits=None, kpos=None, window=None):
    """q (B,T,Hq,dh), k/v (B,S,Hkv,dh) of q's dtype or int8 with k_scale /
    v_scale (B,S,Hkv) f32, qpos (B,T) int32 → (B,T,Hq,dh) in q's dtype.
    A token-tree window adds ``tree_mask`` (T,T) bool and ``win_start``
    (B,) int32 (and optionally the mask's bit words ``tree_bits``); a ring
    cache adds ``kpos`` (B,S) int32 and ``window`` (counted as
    ``flash_decode_ring[_int8]``)."""
    _check(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits,
           kpos=kpos, window=window)
    return ops.dispatch(
        q, lambda: flash_decode_ref(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start,
                                    kpos, window),
        lambda: _launch(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits,
                        kpos=kpos, window=window),
        (k, v, k_scale, v_scale))


def flash_decode_cross(q, k, v):
    """q (B,T,Hq,dh) over every one of the S keys of k/v (B,S,Hkv,dh) of
    q's dtype, counted as ``flash_decode_cross`` (the cross-attention read,
    ``models/attention.cross_attend``).  The card takes no positions (bf16:
    one launch of the sliced body); the plain version is
    :func:`flash_decode_ref` with every query at position S - 1.  Training
    reaches it: on the card a call that needs a gradient launches the kernel
    forward and takes the plain version's vector-Jacobian product backward
    (``ops.dispatch_differentiable``)."""
    _check(q, k, v, None, None, None, None, None, None)

    def plain(q, k, v):
        qpos = torch.full(q.shape[:2], k.shape[1] - 1, dtype=torch.int32, device=q.device)
        return flash_decode_ref(q, k, v, qpos)

    return ops.dispatch_differentiable(plain, _launch_cross, q, k, v)


def flash_decode_paged(q, k, v, bt, qpos, *, k_scale=None, v_scale=None, tree_mask=None,
                       win_start=None, tree_bits=None):
    """q (B,T,Hq,dh); k/v pools (N,bs,Hkv,dh) of q's dtype or int8 with
    k_scale / v_scale pools (N,bs,Hkv) f32; bt (B,nb) int32 physical block
    ids (unallocated logical blocks at the scratch block 0); qpos (B,T)
    int32 → (B,T,Hq,dh) in q's dtype, as :func:`flash_decode` over the
    logical ``(B, nb·bs)`` view.  Token-tree windows as there.  The table's
    ids are the host allocator's and are not range-checked on the card."""
    _check(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits, paged=True)
    _check_table(q, k, bt)
    return ops.dispatch(
        q, lambda: flash_decode_paged_ref(q, k, v, bt, qpos, k_scale, v_scale, tree_mask,
                                          win_start),
        lambda: _launch(q, k, v, qpos, k_scale, v_scale, tree_mask, win_start, tree_bits,
                        bt=bt), (k, v, k_scale, v_scale))
