"""GQA self-attention with a contiguous KV cache — port of the contiguous,
non-ring path of ``repro/models/attention.py``.

Modes: **prefill** (``read_cache=False``) writes K/V into the cache and
attends over the chunk's own keys; **decode / verify** writes a T-token
window at per-row positions and attends over the whole buffer with a
position mask (slot index == absolute position), so speculative rollback
is free: uncommitted slots hold future positions and stay masked until
rewritten.  A token-tree verify window writes node ``i`` at slot
``start + i`` (the ``slots`` override) while its position is
``start + depth[i]``, and the template's ancestor mask replaces position
causality over the window's slots.  The cache-read call goes to the
``flash_decode`` kernel wrapper (CUDA kernel on the card, plain version on
the CPU).

Cache layout per layer: ``{"k","v": (B, S, Hkv, dh)}``, plus
``{"k_scale","v_scale": (B, S, Hkv)}`` f32 when ``kv_cache_dtype="int8"``.
Unlike the reference's functional update, :func:`write_cache` writes the
cache tensors **in place** (one buffer per layer instead of a copy per
step) and returns the same dict.

**Paged cache** (``block_tables`` given): the layer's cache holds
physical pools ``(N, bs, Hkv, dh)`` (``core/paged_cache.py``) and logical
slots map through the ``(B, nb)`` block table.  :func:`write_cache_paged`
scatters the window's rows into the pools in place, and
:func:`attend_paged` reads them through the ``flash_decode_paged``
wrapper: the CUDA kernel on the card, the gather-then-``flash_decode_ref``
plain version on the CPU.  Decode/verify only — admission prefills a
contiguous row and scatters it into blocks.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.paged_cache import physical_slots
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged, tree_override
from repro_torch.kernels.smooth_quant import INV_INT8_MAX
from repro_torch.models.common import apply_rope
from repro_torch.models.ffn import apply_linear
from repro_torch.models.linear import Linear

MASK_VAL = -1e30
CHUNK_THRESHOLD = 4096  # use the online-softmax path beyond this many keys
KV_CHUNK = 1024


def init_attn_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zeroed cache buffers.  Zeros, never uninitialised memory: masked
    slots still enter p·V with p = 0, and 0·NaN = NaN."""
    int8 = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if int8 else cfg.dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if int8:
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return cache


# ---------------------------------------------------------------------------
# Core attend: q (B,T,Hq,dh) over k/v (B,S,Hkv,dh) with a position mask
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, tree_mask=None, win_start=None):
    """Causal position mask: qpos (B,T); kpos (B,S) or (S,) → (B,1,1,T,S)
    bool, key visible iff kpos <= qpos.  With a token-tree window the slots
    [win_start, win_start + T) hold the window's nodes in packed order, and
    there the ancestor-or-self ``tree_mask`` (T, T) decides instead;
    slots past the window stay masked by position."""
    if kpos.dim() == 1:
        kpos = kpos[None, :]
    valid = (qpos[:, :, None] - kpos[:, None, :]) >= 0
    if tree_mask is not None:
        valid = tree_override(valid, kpos, tree_mask, win_start)
    return valid[:, None, None, :, :]


def _attend_direct(q, k, v, valid, k_scale=None, v_scale=None):
    B, T, Hq, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, dh)
    s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    if k_scale is not None:   # int8 KV: per-(token, head) scale folded into scores
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    s = s * (dh ** -0.5)
    s = torch.where(valid, s, MASK_VAL)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:   # fold the value scale into the probabilities
        p = p * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return o.reshape(B, T, Hq, dh).to(q.dtype)


def _attend_chunked(q, k, v, valid, k_scale=None, v_scale=None):
    """Online softmax over KV chunks of ``KV_CHUNK`` keys (S a multiple)."""
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, dh).float()
    scale = dh ** -0.5
    m = torch.full((B, Hkv, G, T), MASK_VAL, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, T, dh), dtype=torch.float32, device=q.device)
    for c in range(0, S, KV_CHUNK):
        sl = slice(c, c + KV_CHUNK)
        valid_i = valid[..., sl].reshape(B, 1, 1, T, -1)
        s = torch.einsum("btkgh,bskh->bkgts", qg, k[:, sl].float()) * scale
        if k_scale is not None:
            s = s * k_scale[:, sl].permute(0, 2, 1)[:, :, None, None, :]
        s = torch.where(valid_i, s, MASK_VAL)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid_i, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * v_scale[:, sl].permute(0, 2, 1)[:, :, None, None, :]
        acc = acc * alpha[..., None] + torch.einsum("bkgts,bskh->bkgth", p, v[:, sl].float())
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, dh).to(q.dtype)


def _flash_eligible(kpos) -> bool:
    """The flash_decode kernel covers exactly the cache-read decode/verify
    shape: causal attention over a contiguous cache whose slot index is
    the position (1-D ``kpos``).  The prefill self-window (2-D ``kpos``)
    stays on the plain path, as in the reference.  (The port's attention
    is causal throughout; the reference's non-causal encoder and
    cross-attention wait for the slices that port those models.)"""
    return kpos.dim() == 1


def attend(q, k, v, qpos, kpos, *, k_scale=None, v_scale=None, tree_mask=None,
           win_start=None, tree_bits=None, plain: bool = False):
    """Position-masked attention (tree-masked over a token-tree window).
    Flash-eligible calls go to the ``flash_decode`` wrapper; the others —
    and every call with ``plain=True``, the reference's ``impl="jnp"`` —
    run the plain path."""
    if not plain and _flash_eligible(kpos):
        return flash_decode(q, k, v, qpos, k_scale=k_scale, v_scale=v_scale,
                            tree_mask=tree_mask, win_start=win_start,
                            tree_bits=tree_bits)
    valid = _mask(qpos, kpos, tree_mask, win_start)
    S = k.shape[1]
    if S > CHUNK_THRESHOLD:
        pad = (-S) % KV_CHUNK
        if pad:   # masked junk columns keep the chunked path for any S
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
            if k_scale is not None:
                k_scale = torch.nn.functional.pad(k_scale, (0, 0, 0, pad))
                v_scale = torch.nn.functional.pad(v_scale, (0, 0, 0, pad))
        return _attend_chunked(q, k, v, valid, k_scale, v_scale)
    return _attend_direct(q, k, v, valid, k_scale, v_scale)


def attend_paged(q, cache: dict, bt, qpos, *, tree_mask=None, win_start=None,
                 tree_bits=None):
    """Position-masked attention over a **paged** cache layer: ``cache``
    holds the pools ``k``/``v`` (N, bs, Hkv, dh) (+ int8 scale pools) and
    ``bt`` is the (B, nb) block table.  Always the ``flash_decode_paged``
    wrapper: its kernel on a CUDA tensor (never a gather followed by the
    contiguous kernel), its plain version (gather + ``flash_decode_ref``)
    on a CPU tensor."""
    return flash_decode_paged(q, cache["k"], cache["v"], bt, qpos,
                              k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                              tree_mask=tree_mask, win_start=win_start, tree_bits=tree_bits)


# ---------------------------------------------------------------------------
# Cache write
# ---------------------------------------------------------------------------

def _quant_kv(x):
    """(B, T, H, dh) → (int8 values, (B, T, H) f32 scales).  The scale is
    multiplied by f32(1/127), as in the jitted reference (see
    kernels/smooth_quant.py)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) * INV_INT8_MAX
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def write_cache(cache: dict, k, v, slots) -> dict:
    """Scatter T new K/V rows into the cache at per-row slots (the absolute
    positions, or a tree window's packed slots), in place."""
    bidx = torch.arange(slots.shape[0], device=slots.device)[:, None]
    slots = slots.long()
    if cache["k"].dtype == torch.int8:
        k, ks = _quant_kv(k)
        v, vs = _quant_kv(v)
        cache["k_scale"][bidx, slots] = ks
        cache["v_scale"][bidx, slots] = vs
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    return cache


def last_writer(rows: torch.Tensor) -> torch.Tensor:
    """For each write of ``rows`` (n,), the index of the last write to the
    same row: an (n, n) comparison, static shapes, no sort."""
    order = torch.arange(rows.numel(), device=rows.device)
    return ((rows[:, None] == rows[None, :]) * order).amax(dim=1)


def write_cache_paged(cache: dict, k, v, slots, bt, last_wins: bool = False) -> dict:
    """Scatter T new K/V rows into a *paged* layer pool through the block
    table, in place.  ``slots`` (B, T) are logical slots;
    ``core/paged_cache.physical_slots`` maps them onto rows of the pool
    viewed as ``(N * bs, Hkv, dh)``.  Rows never collide across live rows:
    the host forks a shared block (copy-on-write) before a window can
    reach it.  Idle rows (and slots past a row's table) land in the
    scratch block, whose content no live row's kept output reads.

    Several of those writes can land on one scratch row, and on the card
    which of them sticks is not fixed from run to run.  ``last_wins``
    gives every write to a row the values of the last write to it (in
    (row, t) order, what a sequential scatter leaves), so what an idle row
    reads back does not depend on that race.  Needed where rows interact:
    an MoE layer whose capacity is below its expert count, where an idle
    row's routing takes expert slots from the live rows."""
    phys = physical_slots(bt, slots, cache["k"].shape[1]).reshape(-1)      # (B*T,)
    if last_wins:
        src = last_writer(phys)
        k = k.reshape((-1,) + tuple(k.shape[2:])).index_select(0, src).view(k.shape)
        v = v.reshape((-1,) + tuple(v.shape[2:])).index_select(0, src).view(v.shape)
    if cache["k"].dtype == torch.int8:
        k, ks = _quant_kv(k)
        v, vs = _quant_kv(v)
        for name, vals in (("k_scale", ks), ("v_scale", vs)):
            cache[name].view(-1, vals.shape[-1])[phys] = vals.reshape(-1, vals.shape[-1])
    for name, vals in (("k", k), ("v", v)):
        buf = cache[name]
        buf.view((-1,) + tuple(buf.shape[2:]))[phys] = \
            vals.reshape((-1,) + tuple(vals.shape[2:])).to(buf.dtype)
    return cache


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg, q: nn.Module, k: nn.Module, v: nn.Module, o: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.q, self.k, self.v, self.o = q, k, v, o

    @classmethod
    def init(cls, generator, cfg, device):
        D, dt = cfg.d_model, cfg.dtype
        b = cfg.attn_bias or cfg.ffn_bias
        return cls(cfg,
                   Linear.init(generator, D, cfg.q_dim, b, dt, device),
                   Linear.init(generator, D, cfg.kv_dim, b, dt, device),
                   Linear.init(generator, D, cfg.kv_dim, b, dt, device),
                   Linear.init(generator, cfg.q_dim, D, cfg.ffn_bias, dt, device))

    def readers(self) -> tuple:
        """The linears that read the attention's input (its norm's readers)."""
        return (self.q, self.k, self.v)

    def forward(self, x, qpos, *, cache: dict | None = None, read_cache: bool = True,
                collect=None, path: str = "", tree: dict | None = None,
                block_tables=None, plain_attn: bool = False):
        """x (B,T,D) (or its norm's ``NormedCodes``), qpos (B,T) int32 →
        (out (B,T,D), cache or None).

        ``tree`` (a token-tree verify window): ``slots`` (B,T) where the
        window's K/V go, ``mask`` (T,T) and its bit words ``bits``, and
        ``win_start`` (B,), the window's first slot.  ``block_tables``
        (B, nb) int32 makes ``cache`` a paged layer pool.  ``plain_attn``
        reads the cache through the plain path (chunked prefill)."""
        cfg = self.cfg
        B, T, _ = x.shape
        q = apply_linear(self.q, x, collect, f"{path}/q").reshape(B, T, cfg.num_heads, cfg.head_dim)
        k = apply_linear(self.k, x, collect, f"{path}/k").reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        v = apply_linear(self.v, x, collect, f"{path}/v").reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        if cfg.use_rope:
            q = apply_rope(q, qpos, cfg.rope_theta)
            k = apply_rope(k, qpos, cfg.rope_theta)
        tree = tree or {}
        slots = tree.get("slots", qpos)
        masks = dict(tree_mask=tree.get("mask"), win_start=tree.get("win_start"),
                     tree_bits=tree.get("bits"))
        if cache is not None and block_tables is not None:     # paged: decode/verify
            cache = write_cache_paged(cache, k, v, slots, block_tables,
                                      last_wins=cfg.is_moe and
                                      cfg.moe_capacity_factor < cfg.num_experts)
            o = attend_paged(q, cache, block_tables, qpos, **masks)
        elif cache is not None:
            cache = write_cache(cache, k, v, slots)
            if read_cache:
                kpos = torch.arange(cache["k"].shape[1], dtype=torch.int32, device=x.device)
                o = attend(q, cache["k"], cache["v"], qpos, kpos,
                           k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                           plain=plain_attn, **masks)
            else:
                o = attend(q, k, v, qpos, qpos)
        else:
            o = attend(q, k, v, qpos, qpos)
        out = apply_linear(self.o, o.reshape(B, T, cfg.q_dim), collect, f"{path}/o")
        return out, cache
