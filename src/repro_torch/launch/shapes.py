"""The four assigned input shapes and per-(arch × shape) input specs — port
of ``repro/launch/shapes.py``.

Decode shapes are one speculative iteration (γ+1-token verify window)
against a KV cache of ``seq_len``.  ``long_500k`` switches full-attention
archs to the sliding-window variant (window 4096), whose caches are rings
of 4096 + ``RING_PAD`` slots (``models/attention.py``); SSM archs need
nothing.

Everything here returns ``torch.empty(..., device="meta")`` stand-ins for
the reference's ``jax.ShapeDtypeStruct``: shapes and dtypes, nothing
allocated.  The serve state comes from the engine's own
``core/spec_engine.init_state`` on the meta device, so the schema has one
source, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LONG_WINDOW = 4096

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
META = torch.device("meta")


def shape_cfg(cfg, shape_name: str):
    """Arch config adapted to the input shape (sliding window for 500k)."""
    if shape_name == "long_500k" and cfg.arch_type != "ssm" and cfg.num_heads:
        if cfg.sliding_window is None or cfg.sliding_window > LONG_WINDOW:
            return dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
    return cfg


def meta_tensor(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` with no storage."""
    return torch.empty(shape, dtype=dtype, device=META)


def _aux_spec(cfg, batch: int) -> Optional[torch.Tensor]:
    """Modality-frontend stubs: precomputed patch/frame embeddings."""
    n = cfg.num_image_tokens or cfg.num_audio_frames
    if not n:
        return None
    return meta_tensor((batch, n, cfg.d_model), cfg.dtype)


def train_specs(cfg, shape_name: str) -> dict:
    s = SHAPES[shape_name]
    B, T = s["global_batch"], s["seq_len"]
    batch = {"tokens": meta_tensor((B, T), torch.int32),
             "labels": meta_tensor((B, T), torch.int32)}
    aux = _aux_spec(cfg, B)
    if aux is not None:
        batch["aux_embeds"] = aux
    return batch


def _meta_model(cfg, model):
    from repro_torch.models.model import Model

    return model if model is not None and model.device == META else Model(cfg, device=META)


def prefill_specs(cfg, shape_name: str, model=None, scan: bool = False) -> dict:
    """``scan`` stacks the cache as the reference's scan layout does
    (``models/scan.stack_cache``); the port runs the per-layer layout."""
    from repro_torch.models import scan as S

    s = SHAPES[shape_name]
    B, T = s["global_batch"], s["seq_len"]
    cache = _meta_model(cfg, model).init_cache(B, T + 256)
    out = {"cache": S.stack_cache(cache, cfg) if scan else cache,
           "tokens": meta_tensor((B, T), torch.int32)}
    aux = _aux_spec(cfg, B)
    if aux is not None:
        out["aux_embeds"] = aux
    return out


def serve_state_specs(cfg, shape_name: str, model=None, scfg=None,
                      scan: bool = False) -> dict:
    """Engine state for one speculative serve step at this decode shape.
    Its ``generators`` (one ``torch.Generator`` per row, the reference's
    ``key``) hold no device tensor and are left empty here."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.core.spec_engine import init_state
    from repro_torch.models import scan as S

    scfg = scfg if scfg is not None else SpecConfig()
    s = SHAPES[shape_name]
    B, S_ = s["global_batch"], s["seq_len"]
    buf = S_ + scfg.gamma + 130  # committed context + speculative slack
    state = init_state(_meta_model(cfg, model), B, buf, [],
                       target=meta_tensor((B,), torch.int32))
    if scan:
        state["cache"] = S.stack_cache(state["cache"], cfg)
    return state
