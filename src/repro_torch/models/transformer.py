"""Decoder stack — port of the ``dense`` path of
``repro/models/transformer.py``: self-attention + FFN blocks over a
contiguous KV cache.

The parameter tree is an ``nn.Module`` tree whose submodule paths are the
reference pytree's paths (``embed/w``, ``layers/<i>/attn/q``,
``layers/<i>/ffn/up``, ``final_norm``, ``lm_head``), so calibration
statistics, quantization and the weight bridge address linears by the
same names.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.attention import Attention, init_attn_cache
from repro_torch.models.common import Norm, embed_init
from repro_torch.models.ffn import FFN
from repro_torch.models.linear import Linear
from repro_torch.quant.smoothquant import record_act_stats


def check_supported(cfg) -> None:
    if cfg.arch_type != "dense" or cfg.sliding_window or cfg.cross_attn_every:
        raise NotImplementedError(
            f"the port runs dense decoders over a contiguous cache; "
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
    """Dense decoder block: x + attn(norm(x)), then + ffn(norm(x))."""

    def __init__(self, attn_norm: Norm, attn: Attention, ffn_norm: Norm, ffn: FFN):
        super().__init__()
        self.attn_norm, self.attn, self.ffn_norm, self.ffn = attn_norm, attn, ffn_norm, ffn

    @classmethod
    def init(cls, generator, cfg, device):
        return cls(Norm(cfg, cfg.d_model, device), Attention.init(generator, cfg, device),
                   Norm(cfg, cfg.d_model, device), FFN.init(generator, cfg, device))

    def forward(self, x, qpos, cache=None, *, read_cache=True, collect=None, path=""):
        h, cache = self.attn(self.attn_norm(x), qpos, cache=cache,
                             read_cache=read_cache, collect=collect, path=f"{path}/attn")
        x = x + h
        x = x + self.ffn(self.ffn_norm(x), collect, f"{path}/ffn")
        return x, cache


class Transformer(nn.Module):
    """The parameter tree and the forward pass of one dense decoder."""

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
        layers = [Block.init(generator, cfg, device) for _ in range(cfg.num_layers)]
        lm_head = (None if cfg.tie_embeddings else
                   Linear.init(generator, cfg.d_model, cfg.vocab_size, False, cfg.dtype, device))
        embed = Embed(embed_init(generator, (cfg.vocab_size, cfg.d_model), cfg.dtype, device))
        return cls(cfg, embed, layers, Norm(cfg, cfg.d_model, device), lm_head)

    def forward(self, tokens, start, *, cache: Optional[dict] = None,
                read_cache: bool = True, collect=None, need_logits: bool = True,
                path: str = ""):
        """tokens (B,T) int, start (B,) first position →
        (logits (B,T,V) f32 or None, cache or None)."""
        cfg = self.cfg
        T = tokens.shape[1]
        qpos = (start[:, None] + torch.arange(T, dtype=torch.int32, device=tokens.device)
                ).to(torch.int32)
        x = self.embed.w[tokens.long()].to(cfg.dtype)
        for i, blk in enumerate(self.layers):
            lcache = cache["layers"][i] if cache is not None else None
            x, lcache = blk(x, qpos, lcache, read_cache=read_cache, collect=collect,
                            path=f"{path}layers/{i}")
        logits = None
        if need_logits:
            x = self.final_norm(x)
            if cfg.tie_embeddings:
                logits = x.float() @ self.embed.w.float().T
            else:
                if collect is not None:
                    record_act_stats(collect, f"{path}lm_head", x)
                logits = self.lm_head(x).float()
        return logits, cache


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Allocate the serving cache.  ``max_len`` is rounded up so the chunked
    attention path (multiples of 1024) always applies to big buffers."""
    check_supported(cfg)
    max_len = -(-max_len // 1024) * 1024 if max_len > 4096 else -(-max_len // 128) * 128
    return {"layers": [init_attn_cache(cfg, batch, max_len, device)
                       for _ in range(cfg.num_layers)]}


def commit_cache(cfg, cache: dict, n_last) -> dict:
    """Resolve verify-candidate caches after acceptance.  Attention caches
    need no work: slot positions and masking handle rollback."""
    return cache
