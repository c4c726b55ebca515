"""Decoder stack — port of the ``dense`` and ``moe`` paths of
``repro/models/transformer.py``: self-attention + FFN (or MoE FFN) blocks
over a contiguous or paged KV cache, with the pruned-stack (``num_layers``)
and token-tree verify windows, and the tree commit.

The parameter tree is an ``nn.Module`` tree whose submodule paths are the
reference pytree's paths (``embed/w``, ``layers/<i>/attn/q``,
``layers/<i>/ffn/up``, ``layers/<i>/moe/{router,up,gate,down,dense}``,
``final_norm``, ``lm_head``), so calibration statistics, quantization and
the weight bridge address linears by the same names.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn

from repro_torch.core.paged_cache import physical_slots
from repro_torch.models.attention import Attention, init_attn_cache
from repro_torch.models.common import Norm, embed_init
from repro_torch.models.ffn import FFN, apply_linear
from repro_torch.models.linear import Linear
from repro_torch.models.moe import MoE


def layer_kinds(cfg) -> List[str]:
    """Each layer's kind, as the reference derives it (``dense`` or ``moe``
    among the families the port runs; ``ssm``, ``cross`` and ``audio`` for
    the others)."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.arch_type in ("ssm", "hybrid"):
            kinds.append("ssm")
        elif cfg.arch_type == "audio":
            kinds.append("audio")
        elif cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            kinds.append("cross")
        elif cfg.is_moe:
            kinds.append("moe")
        else:
            kinds.append("dense")
    return kinds


def check_supported(cfg) -> None:
    if (cfg.arch_type not in ("dense", "moe") or cfg.sliding_window or cfg.encoder_layers
            or set(layer_kinds(cfg)) - {"dense", "moe"}):
        raise NotImplementedError(
            f"the port runs dense and MoE full-attention decoders; "
            f"{cfg.name} ({cfg.arch_type}, window={cfg.sliding_window}) waits "
            "for a later slice")
    if cfg.attn_impl != "auto":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}: the port dispatches "
                         "attention by device, and 'auto' is its only value")


class Embed(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)


class Block(nn.Module):
    """Decoder block: x + attn(norm(x)), then + ffn(norm(x)) (a dense
    block) or + moe(norm(x)) (an MoE block: exactly one of ``ffn`` and
    ``moe`` is set).  Each norm is told which linears read it, so on the
    card it can quantize for them in the same launch
    (``models/common.Norm``); calibration (``collect``) needs the normed
    tensor and tells it none, and so does an MoE block's FFN norm, which
    the f32 router reads."""

    def __init__(self, attn_norm: Norm, attn: Attention, ffn_norm: Norm,
                 ffn: Optional[FFN] = None, moe: Optional[MoE] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block has either an FFN or an MoE FFN")
        self.attn_norm, self.attn, self.ffn_norm = attn_norm, attn, ffn_norm
        self.ffn, self.moe = ffn, moe

    @classmethod
    def init(cls, generator, cfg, device, kind: str = "dense"):
        attn_norm, attn = Norm(cfg, cfg.d_model, device), Attention.init(generator, cfg, device)
        ffn_norm = Norm(cfg, cfg.d_model, device)
        if kind == "moe":
            return cls(attn_norm, attn, ffn_norm, moe=MoE.init(generator, cfg, device))
        return cls(attn_norm, attn, ffn_norm, ffn=FFN.init(generator, cfg, device))

    def forward(self, x, qpos, cache=None, *, read_cache=True, collect=None, path="",
                tree=None, block_tables=None, plain_attn=False, aux=None):
        calib = collect is not None
        h, cache = self.attn(self.attn_norm(x, () if calib else self.attn.readers()), qpos,
                             cache=cache, read_cache=read_cache, collect=collect,
                             path=f"{path}/attn", tree=tree, block_tables=block_tables,
                             plain_attn=plain_attn)
        x = x + h
        if self.moe is not None:
            return x + self.moe(self.ffn_norm(x), collect, f"{path}/moe", aux), cache
        x = x + self.ffn(self.ffn_norm(x, () if calib else self.ffn.readers()), collect,
                         f"{path}/ffn")
        return x, cache


class Transformer(nn.Module):
    """The parameter tree and the forward pass of one dense or MoE decoder."""

    def __init__(self, cfg, embed: Embed, layers, final_norm: Norm,
                 lm_head: Optional[nn.Module]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head

    @classmethod
    def init(cls, cfg, generator: torch.Generator, device) -> "Transformer":
        """Seeded random weights with the reference's distributions."""
        check_supported(cfg)
        layers = [Block.init(generator, cfg, device, kind) for kind in layer_kinds(cfg)]
        lm_head = (None if cfg.tie_embeddings else
                   Linear.init(generator, cfg.d_model, cfg.vocab_size, False, cfg.dtype, device))
        embed = Embed(embed_init(generator, (cfg.vocab_size, cfg.d_model), cfg.dtype, device))
        return cls(cfg, embed, layers, Norm(cfg, cfg.d_model, device), lm_head)

    def forward(self, tokens, start, *, cache: Optional[dict] = None,
                read_cache: bool = True, collect=None, need_logits: bool = True,
                path: str = "", num_layers: Optional[int] = None,
                tree_depths=None, tree_mask=None, tree_bits=None,
                plain_attn: bool = False, aux: Optional[list] = None):
        """tokens (B,T) int, start (B,) first position →
        (logits (B,T,V) f32 or None, cache or None).  ``aux``: a list each
        MoE layer appends its load-balance loss to (``Model.forward``); the
        decode and verify steps pass none and compute none.

        ``num_layers`` runs the first layers only (the pruned drafter); the
        final norm and ``lm_head`` still apply.  ``tree_depths`` (T,) and
        ``tree_mask`` (T, T) bool make the window a packed token tree:
        positions follow node depth while cache slots follow packed order
        (``start + arange(T)``), and the ancestor mask replaces position
        causality inside the window; ``tree_bits`` is the mask as the bit
        words the attention kernel reads (``TreeTables.mask_bits``).

        A cache holding a block table ``"bt"`` is the paged serving cache
        (``core/paged_cache.py``): decode/verify only, since admission
        prefills a contiguous row and scatters it into blocks.
        ``plain_attn`` reads the cache through the plain attention path
        (``Model.prefill_chunk``)."""
        cfg = self.cfg
        block_tables = cache.get("bt") if cache is not None else None
        if block_tables is not None and not read_cache:
            raise NotImplementedError(
                "paged caches do not support forward-pass prefill; admission "
                "prefills a contiguous row and scatters it into the pool")
        T = tokens.shape[1]
        arange = torch.arange(T, dtype=torch.int32, device=tokens.device)
        tree = None
        if tree_depths is not None:
            qpos = (start[:, None] + tree_depths[None, :]).to(torch.int32)
            tree = dict(slots=(start[:, None] + arange).to(torch.int32),
                        mask=tree_mask, bits=tree_bits, win_start=start)
        else:
            qpos = (start[:, None] + arange).to(torch.int32)
        x = self.embed.w[tokens.long()].to(cfg.dtype)
        for i, blk in enumerate(self.layers[:num_layers or cfg.num_layers]):
            lcache = cache["layers"][i] if cache is not None else None
            x, lcache = blk(x, qpos, lcache, read_cache=read_cache, collect=collect,
                            path=f"{path}layers/{i}", tree=tree,
                            block_tables=block_tables, plain_attn=plain_attn, aux=aux)
        logits = None
        if need_logits:
            if cfg.tie_embeddings:
                x = self.final_norm(x)
                logits = x.float() @ self.embed.w.float().T
            else:
                x = self.final_norm(x, () if collect is not None else (self.lm_head,))
                logits = apply_linear(self.lm_head, x, collect, f"{path}lm_head").float()
        return logits, cache


def with_config(params: Transformer, cfg) -> Transformer:
    """A view of ``params`` under another configuration of the same shapes
    (e.g. a dropless MoE capacity factor): every tensor shared.  The
    reference passes the config beside its params; the port's modules hold
    it."""
    check_supported(cfg)
    out = copy.deepcopy(params, {id(t): t for t in params.buffers()})
    for mod in out.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = cfg
    return out


def init_cache(cfg, batch: int, max_len: int, device,
               num_layers: Optional[int] = None) -> dict:
    """Allocate the serving cache (of the first ``num_layers`` layers).
    ``max_len`` is rounded up so the chunked attention path (multiples of
    1024) always applies to big buffers."""
    check_supported(cfg)
    max_len = -(-max_len // 1024) * 1024 if max_len > 4096 else -(-max_len // 128) * 128
    return {"layers": [init_attn_cache(cfg, batch, max_len, device)
                       for _ in range(num_layers or cfg.num_layers)]}


def commit_cache(cfg, cache: dict, n_last) -> dict:
    """Resolve verify-candidate caches after acceptance.  Attention caches
    need no work: slot positions and masking handle rollback."""
    return cache


def _compact_attn_rows(lcache: dict, start, path_nodes, n_accept) -> dict:
    """Move the accepted tree path's K/V rows into chain slots, in place.

    A tree window wrote node ``i`` at slot ``start + i`` with RoPE position
    ``start + depth[i]``; an accepted node at depth ``d`` has position
    ``start + d``, its committed slot, so committing is a pure row move
    ``start + path_nodes[d] → start + d`` for ``d ≤ n_accept``.  Both
    sides are gathered before the scatter (``src`` and ``dst`` overlap
    for chains, whose rows move onto themselves)."""
    B, D1 = path_nodes.shape
    D = D1 - 1
    if D == 0:
        return lcache
    S = lcache["k"].shape[1]
    depth = torch.arange(1, D + 1, dtype=torch.int64, device=start.device)[None, :]
    src = (start[:, None].long() + path_nodes[:, 1:].long()).clamp(0, S - 1)   # (B, D)
    dst = (start[:, None].long() + depth).clamp(0, S - 1)
    keep = depth <= n_accept[:, None]                                          # (B, D)
    bidx = torch.arange(B, device=start.device)[:, None]
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in lcache:
            continue
        buf = lcache[name]
        moved, stay = buf[bidx, src], buf[bidx, dst]
        tail = (1,) * (buf.dim() - 2)
        buf[bidx, dst] = torch.where(keep.reshape(keep.shape + tail), moved, stay)
    return lcache


def _compact_attn_rows_paged(lcache: dict, bt, start, path_nodes, n_accept) -> dict:
    """Paged-layout tree commit, in place: the row moves of
    :func:`_compact_attn_rows` with logical slots translated to pool rows
    through the block table.  Live rows move rows only inside their own
    blocks (``start + node <= start + gamma`` is within the request's
    allocation); idle rows compact inside the scratch block, whose content
    is never validly read."""
    B, D1 = path_nodes.shape
    D = D1 - 1
    if D == 0:
        return lcache
    block_size = lcache["k"].shape[1]
    S = bt.shape[1] * block_size
    depth = torch.arange(1, D + 1, dtype=torch.int64, device=start.device)[None, :]
    src = (start[:, None].long() + path_nodes[:, 1:].long()).clamp(0, S - 1)   # (B, D)
    dst = (start[:, None].long() + depth).clamp(0, S - 1)
    keep = depth <= n_accept[:, None]                                          # (B, D)
    phys_src = physical_slots(bt, src, block_size)
    phys_dst = physical_slots(bt, dst, block_size)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in lcache:
            continue
        flat = lcache[name].view((-1,) + tuple(lcache[name].shape[2:]))
        moved, stay = flat[phys_src], flat[phys_dst]                           # (B, D, ...)
        tail = (1,) * (moved.dim() - 2)
        vals = torch.where(keep.reshape(keep.shape + tail), moved, stay)
        flat[phys_dst.reshape(-1)] = vals.reshape((-1,) + tuple(vals.shape[2:]))
    return lcache


def commit_cache_tree(cfg, cache: dict, start, path_nodes, n_accept) -> dict:
    """Resolve tree-verify candidate caches: compact the accepted
    root-to-leaf path of every layer (see :func:`_compact_attn_rows`;
    :func:`_compact_attn_rows_paged` for a paged cache)."""
    bt = cache.get("bt")
    for lcache in cache["layers"]:
        if bt is not None:
            _compact_attn_rows_paged(lcache, bt, start, path_nodes, n_accept)
        else:
            _compact_attn_rows(lcache, start, path_nodes, n_accept)
    return cache
