"""Weight and cache bridge between the reference's pytrees and the port.

``from_jax_params`` turns a reference parameter pytree — given as numpy,
e.g. ``jax.tree.map(np.asarray, params)`` — into the port's parameter tree
(:class:`~repro_torch.models.transformer.Transformer`); ``to_numpy``
converts back.  Both handle the bf16 linear layout ``{"w"[, "b"]}`` and the
W8A8 layout ``{"w_int8", "w_scale", "smooth"[, "b"]}`` and the W4A8
layout ``{"w_int4", ...}``; the port stores ``w_int8`` transposed, (dout,
din) with din contiguous, and ``w_int4`` as (dout, din/2)
(models/linear.py), and ``to_numpy`` transposes both back.  An MoE layer
(``{"moe": {"router", "up", "gate", "down"[, "dense"]}}``) carries batched
expert tensors: ``w`` (E, din, dout), or ``w_int8`` stored (E, dout, din)
with ``w_scale`` (E, dout), transposed the same way.  ``cache_from_numpy`` /
``cache_to_numpy`` do the same for a contiguous or paged cache pytree.

JAX bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses; they cross as their 16-bit patterns
(``uint16`` → ``int16`` → ``bfloat16`` view), so the round trip is
bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import Norm
from repro_torch.models.ffn import FFN
from repro_torch.models.linear import (ExpertLinear, Linear, W4A8Linear, W8A8ExpertLinear,
                                       W8A8Linear)
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Block, Embed, Transformer


def tensor(a, device) -> torch.Tensor:
    """numpy (incl. ``ml_dtypes.bfloat16``) → torch tensor on ``device``."""
    a = np.array(a)          # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def array(t: torch.Tensor) -> np.ndarray:
    """torch tensor → numpy; bf16 comes back as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def _linear(p: dict, device):
    b = tensor(p["b"], device) if "b" in p else None
    for name, cls in (("w_int8", W8A8Linear), ("w_int4", W4A8Linear)):
        if name in p:
            w = tensor(p[name], device).T.contiguous()    # (din[/2],dout) → (dout,din[/2])
            return cls(w, tensor(p["w_scale"], device), tensor(p["smooth"], device), b)
    return Linear(tensor(p["w"], device), b)


def _expert_linear(p: dict, device):
    if "w_int8" in p:     # (E, din, dout) → (E, dout, din)
        return W8A8ExpertLinear(tensor(p["w_int8"], device).transpose(1, 2).contiguous(),
                                tensor(p["w_scale"], device), tensor(p["smooth"], device))
    return ExpertLinear(tensor(p["w"], device))


def _ffn(cfg, p: dict, device) -> FFN:
    return FFN(cfg, _linear(p["up"], device), _linear(p["down"], device),
               _linear(p["gate"], device) if "gate" in p else None)


def _moe(cfg, p: dict, device) -> MoE:
    return MoE(cfg, _linear(p["router"], device), _expert_linear(p["up"], device),
               _expert_linear(p["down"], device),
               _expert_linear(p["gate"], device) if "gate" in p else None,
               _ffn(cfg, p["dense"], device) if "dense" in p else None)


def _norm(cfg, p: dict, device) -> Norm:
    n = Norm(cfg, np.asarray(p["scale"]).shape[0], device)
    n.scale = tensor(p["scale"], device)
    if "bias" in p:
        n.bias = tensor(p["bias"], device)
    return n


def from_jax_params(tree: dict, cfg, device="cuda") -> Transformer:
    """Reference parameter pytree (numpy leaves) → the port's parameters."""
    dev = resolve_device(device)
    layers = []
    for lp in tree["layers"]:
        a = lp["attn"]
        attn = Attention(cfg, *(_linear(a[n], dev) for n in ("q", "k", "v", "o")))
        layers.append(Block(_norm(cfg, lp["attn_norm"], dev), attn,
                            _norm(cfg, lp["ffn_norm"], dev),
                            ffn=_ffn(cfg, lp["ffn"], dev) if "ffn" in lp else None,
                            moe=_moe(cfg, lp["moe"], dev) if "moe" in lp else None))
    lm_head = _linear(tree["lm_head"], dev) if "lm_head" in tree else None
    return Transformer(cfg, Embed(tensor(tree["embed"]["w"], dev)), layers,
                       _norm(cfg, tree["final_norm"], dev), lm_head)


def _linear_np(m) -> dict:
    if isinstance(m, W8A8ExpertLinear):
        return {"w_int8": array(m.w_int8.transpose(1, 2)), "w_scale": array(m.w_scale),
                "smooth": array(m.smooth)}
    if isinstance(m, ExpertLinear):
        return {"w": array(m.w)}
    if isinstance(m, (W8A8Linear, W4A8Linear)):
        name = "w_int8" if isinstance(m, W8A8Linear) else "w_int4"
        out = {name: array(getattr(m, name).T), "w_scale": array(m.w_scale),
               "smooth": array(m.smooth)}
    else:
        out = {"w": array(m.w)}
    if m.b is not None:
        out["b"] = array(m.b)
    return out


def _ffn_np(f: FFN) -> dict:
    out = {"up": _linear_np(f.up), "down": _linear_np(f.down)}
    if f.gate is not None:
        out["gate"] = _linear_np(f.gate)
    return out


def _norm_np(n: Norm) -> dict:
    out = {"scale": array(n.scale)}
    if n.bias is not None:
        out["bias"] = array(n.bias)
    return out


def to_numpy(params: Transformer) -> dict:
    """The port's parameters → the reference's pytree layout (numpy)."""
    layers = []
    for blk in params.layers:
        attn = {n: _linear_np(getattr(blk.attn, n)) for n in ("q", "k", "v", "o")}
        layer = {"attn_norm": _norm_np(blk.attn_norm), "attn": attn,
                 "ffn_norm": _norm_np(blk.ffn_norm)}
        if blk.moe is not None:
            moe = {n: _linear_np(getattr(blk.moe, n)) for n in ("router", "up", "down")}
            if blk.moe.gate is not None:
                moe["gate"] = _linear_np(blk.moe.gate)
            if blk.moe.dense is not None:
                moe["dense"] = _ffn_np(blk.moe.dense)
            layer["moe"] = moe
        else:
            layer["ffn"] = _ffn_np(blk.ffn)
        layers.append(layer)
    tree = {"embed": {"w": array(params.embed.w)}, "layers": layers,
            "final_norm": _norm_np(params.final_norm)}
    if params.lm_head is not None:
        tree["lm_head"] = _linear_np(params.lm_head)
    return tree


def cache_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference cache pytree (numpy leaves) → the port's cache: contiguous
    ``{"layers": [{"k","v"[,scales]}]}``, or paged with the pools as the
    layers and the block table ``"bt"`` beside them."""
    dev = resolve_device(device)
    out = {"layers": [{k: tensor(v, dev) for k, v in layer.items()}
                      for layer in tree["layers"]]}
    if "bt" in tree:
        out["bt"] = tensor(tree["bt"], dev)
    return out


def cache_to_numpy(cache: dict) -> dict:
    out = {"layers": [{k: array(v) for k, v in layer.items()}
                      for layer in cache["layers"]]}
    if "bt" in cache:
        out["bt"] = array(cache["bt"])
    return out
