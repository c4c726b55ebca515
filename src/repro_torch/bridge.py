"""Weight and cache bridge between the reference's pytrees and the port.

``from_jax_params`` turns a reference parameter pytree — given as numpy,
e.g. ``jax.tree.map(np.asarray, params)`` — into the port's parameter tree
(:class:`~repro_torch.models.transformer.Transformer`); ``to_numpy``
converts back.  Both handle the bf16 linear layout ``{"w"[, "b"]}`` and the
W8A8 layout ``{"w_int8", "w_scale", "smooth"[, "b"]}`` and the W4A8
layout ``{"w_int4", ...}``; the port stores ``w_int8`` transposed, (dout,
din) with din contiguous, and ``w_int4`` as (dout, din/2)
(models/linear.py), and ``to_numpy`` transposes both back.  ``cache_from_numpy`` /
``cache_to_numpy`` do the same for a contiguous cache pytree.

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
from repro_torch.models.linear import Linear, W4A8Linear, W8A8Linear
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
        a, f = lp["attn"], lp["ffn"]
        attn = Attention(cfg, *(_linear(a[n], dev) for n in ("q", "k", "v", "o")))
        ffn = FFN(cfg, _linear(f["up"], dev), _linear(f["down"], dev),
                  _linear(f["gate"], dev) if "gate" in f else None)
        layers.append(Block(_norm(cfg, lp["attn_norm"], dev), attn,
                            _norm(cfg, lp["ffn_norm"], dev), ffn))
    lm_head = _linear(tree["lm_head"], dev) if "lm_head" in tree else None
    return Transformer(cfg, Embed(tensor(tree["embed"]["w"], dev)), layers,
                       _norm(cfg, tree["final_norm"], dev), lm_head)


def _linear_np(m) -> dict:
    if isinstance(m, (W8A8Linear, W4A8Linear)):
        name = "w_int8" if isinstance(m, W8A8Linear) else "w_int4"
        out = {name: array(getattr(m, name).T), "w_scale": array(m.w_scale),
               "smooth": array(m.smooth)}
    else:
        out = {"w": array(m.w)}
    if m.b is not None:
        out["b"] = array(m.b)
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
        ffn = {"up": _linear_np(blk.ffn.up), "down": _linear_np(blk.ffn.down)}
        if blk.ffn.gate is not None:
            ffn["gate"] = _linear_np(blk.ffn.gate)
        layers.append({"attn_norm": _norm_np(blk.attn_norm), "attn": attn,
                       "ffn_norm": _norm_np(blk.ffn_norm), "ffn": ffn})
    tree = {"embed": {"w": array(params.embed.w)}, "layers": layers,
            "final_norm": _norm_np(params.final_norm)}
    if params.lm_head is not None:
        tree["lm_head"] = _linear_np(params.lm_head)
    return tree


def cache_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference contiguous cache pytree ``{"layers": [{"k","v"[,scales]}]}``
    (numpy leaves) → the port's cache."""
    dev = resolve_device(device)
    return {"layers": [{k: tensor(v, dev) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def cache_to_numpy(cache: dict) -> dict:
    return {"layers": [{k: array(v) for k, v in layer.items()}
                       for layer in cache["layers"]]}
