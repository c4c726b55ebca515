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
with ``w_scale`` (E, dout), transposed the same way.  An SSM block
(``{"norm", "ssm": {"in_proj", "out_proj", "conv_w", "conv_b", "A_log",
"D_skip", "dt_bias", "norm"}}``) and zamba2's ``shared_attn`` block map onto
``SSMBlock`` and a dense ``Block``.  ``cache_from_numpy`` /
``cache_to_numpy`` do the same for a contiguous or paged cache pytree,
with its ``"shared"`` attention caches and SSM layers (``{"state",
"conv"}``, or a verify candidate ``{"states_all", "xbc_pad"}``: the port's
candidate also carries the layer's own ``state`` and ``conv``, which
``cache_to_numpy`` leaves out).  llama-3.2-vision's cross layers
(``{"attn_norm", "cross", "gate_attn", "ffn_norm", "ffn", "gate_ffn"}``,
the gates f32 scalars), whisper's decoder blocks (``{"attn_norm", "attn",
"cross_norm", "cross", "ffn_norm", "ffn"}``) and its ``encoder``
(``{"layers", "norm"}``) map onto ``CrossBlock``, ``AudioBlock`` and
``Encoder``; their caches (``{"ck","cv"}`` and ``{"self", "ck", "cv"}``)
cross as they are, nested.

JAX bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses; they cross as their 16-bit patterns
(``uint16`` → ``int16`` → ``bfloat16`` view), so the round trip is
bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, CrossAttention
from repro_torch.models.common import Norm
from repro_torch.models.ffn import FFN
from repro_torch.models.linear import (ExpertLinear, Linear, W4A8Linear, W8A8ExpertLinear,
                                       W8A8Linear)
from repro_torch.models.moe import MoE
from repro_torch.models.scan import unstack_params
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import (AudioBlock, Block, CrossBlock, Embed, Encoder,
                                            SSMBlock, Transformer)


def tensor(a, device) -> torch.Tensor:
    """numpy (incl. ``ml_dtypes.bfloat16``, and the ``|V2`` bf16 bytes of a
    ``.npz`` checkpoint) → torch tensor on ``device``."""
    a = np.array(a)          # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
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


def _attention(cfg, a: dict, dev, cls=Attention):
    return cls(cfg, *(_linear(a[n], dev) for n in ("q", "k", "v", "o")))


def _cross_block(cfg, lp: dict, dev) -> CrossBlock:
    return CrossBlock(_norm(cfg, lp["attn_norm"], dev), _attention(cfg, lp["cross"], dev,
                                                                   CrossAttention),
                      _norm(cfg, lp["ffn_norm"], dev), _ffn(cfg, lp["ffn"], dev),
                      tensor(lp["gate_attn"], dev), tensor(lp["gate_ffn"], dev))


def _audio_block(cfg, lp: dict, dev) -> AudioBlock:
    return AudioBlock(_norm(cfg, lp["attn_norm"], dev), _attention(cfg, lp["attn"], dev),
                      _norm(cfg, lp["cross_norm"], dev),
                      _attention(cfg, lp["cross"], dev, CrossAttention),
                      _norm(cfg, lp["ffn_norm"], dev), _ffn(cfg, lp["ffn"], dev))


def _layer(cfg, lp: dict, dev):
    if "ssm" in lp:
        return _ssm_block(cfg, lp, dev)
    if "cross_norm" in lp:
        return _audio_block(cfg, lp, dev)
    if "cross" in lp:
        return _cross_block(cfg, lp, dev)
    return _block(cfg, lp, dev)


def _block(cfg, lp: dict, dev) -> Block:
    attn = _attention(cfg, lp["attn"], dev)
    return Block(_norm(cfg, lp["attn_norm"], dev), attn, _norm(cfg, lp["ffn_norm"], dev),
                 ffn=_ffn(cfg, lp["ffn"], dev) if "ffn" in lp else None,
                 moe=_moe(cfg, lp["moe"], dev) if "moe" in lp else None)


_SSM_BUFFERS = ("conv_w", "conv_b", "A_log", "D_skip", "dt_bias")


def _ssm_block(cfg, lp: dict, dev) -> SSMBlock:
    p = lp["ssm"]
    ssm = SSM(cfg, _linear(p["in_proj"], dev), _linear(p["out_proj"], dev),
              *(tensor(p[n], dev) for n in _SSM_BUFFERS), _norm(cfg, p["norm"], dev))
    return SSMBlock(_norm(cfg, lp["norm"], dev), ssm)


def from_jax_params(tree: dict, cfg, device="cuda") -> Transformer:
    """Reference parameter pytree (numpy leaves) → the port's parameters.
    A tree in the reference's scan layout (``"scan"``: stacked layer
    groups, what its train CLI saves for more than 8 layers) is taken apart
    into the per-layer layout first (``models/scan.unstack_params``)."""
    dev = resolve_device(device)
    if "scan" in tree:
        tree = unstack_params(tree, cfg)
    layers = [_layer(cfg, lp, dev) for lp in tree["layers"]]
    lm_head = _linear(tree["lm_head"], dev) if "lm_head" in tree else None
    shared = _block(cfg, tree["shared_attn"], dev) if "shared_attn" in tree else None
    encoder = None
    if "encoder" in tree:
        enc = tree["encoder"]
        encoder = Encoder(cfg, [_block(cfg, lp, dev) for lp in enc["layers"]],
                          _norm(cfg, enc["norm"], dev))
    return Transformer(cfg, Embed(tensor(tree["embed"]["w"], dev)), layers,
                       _norm(cfg, tree["final_norm"], dev), lm_head, shared, encoder)


def _linear_tree(m) -> dict:
    if isinstance(m, W8A8ExpertLinear):
        return {"w_int8": m.w_int8.transpose(1, 2), "w_scale": m.w_scale,
                "smooth": m.smooth}
    if isinstance(m, ExpertLinear):
        return {"w": m.w}
    if isinstance(m, (W8A8Linear, W4A8Linear)):
        name = "w_int8" if isinstance(m, W8A8Linear) else "w_int4"
        out = {name: getattr(m, name).T, "w_scale": m.w_scale,
               "smooth": m.smooth}
    else:
        out = {"w": m.w}
    if m.b is not None:
        out["b"] = m.b
    return out


def _ffn_tree(f: FFN) -> dict:
    out = {"up": _linear_tree(f.up), "down": _linear_tree(f.down)}
    if f.gate is not None:
        out["gate"] = _linear_tree(f.gate)
    return out


def _norm_tree(n: Norm) -> dict:
    out = {"scale": n.scale}
    if n.bias is not None:
        out["bias"] = n.bias
    return out


def _attention_tree(a) -> dict:
    return {n: _linear_tree(getattr(a, n)) for n in ("q", "k", "v", "o")}


def _layer_tree(blk) -> dict:
    if isinstance(blk, SSMBlock):
        return _ssm_block_tree(blk)
    if isinstance(blk, CrossBlock):
        return {"attn_norm": _norm_tree(blk.attn_norm), "cross": _attention_tree(blk.cross),
                "gate_attn": blk.gate_attn, "ffn_norm": _norm_tree(blk.ffn_norm),
                "ffn": _ffn_tree(blk.ffn), "gate_ffn": blk.gate_ffn}
    if isinstance(blk, AudioBlock):
        return {"attn_norm": _norm_tree(blk.attn_norm), "attn": _attention_tree(blk.attn),
                "cross_norm": _norm_tree(blk.cross_norm), "cross": _attention_tree(blk.cross),
                "ffn_norm": _norm_tree(blk.ffn_norm), "ffn": _ffn_tree(blk.ffn)}
    return _block_tree(blk)


def _block_tree(blk: Block) -> dict:
    layer = {"attn_norm": _norm_tree(blk.attn_norm), "attn": _attention_tree(blk.attn),
             "ffn_norm": _norm_tree(blk.ffn_norm)}
    if blk.moe is not None:
        moe = {n: _linear_tree(getattr(blk.moe, n)) for n in ("router", "up", "down")}
        if blk.moe.gate is not None:
            moe["gate"] = _linear_tree(blk.moe.gate)
        if blk.moe.dense is not None:
            moe["dense"] = _ffn_tree(blk.moe.dense)
        layer["moe"] = moe
    else:
        layer["ffn"] = _ffn_tree(blk.ffn)
    return layer


def _ssm_block_tree(blk: SSMBlock) -> dict:
    ssm = {"in_proj": _linear_tree(blk.ssm.in_proj), "out_proj": _linear_tree(blk.ssm.out_proj),
           **{n: getattr(blk.ssm, n) for n in _SSM_BUFFERS},
           "norm": _norm_tree(blk.ssm.norm)}
    return {"norm": _norm_tree(blk.norm), "ssm": ssm}


def to_tree(params: Transformer) -> dict:
    """The port's parameters → the reference's pytree layout with the
    port's tensors as leaves (the int8/int4 weights as transposed views):
    what ``train/checkpoint.save_checkpoint`` writes."""
    tree = {"embed": {"w": params.embed.w},
            "layers": [_layer_tree(blk) for blk in params.layers],
            "final_norm": _norm_tree(params.final_norm)}
    if params.lm_head is not None:
        tree["lm_head"] = _linear_tree(params.lm_head)
    if params.shared_attn is not None:
        tree["shared_attn"] = _block_tree(params.shared_attn)
    if params.encoder is not None:
        tree["encoder"] = {"layers": [_block_tree(blk) for blk in params.encoder.layers],
                           "norm": _norm_tree(params.encoder.norm)}
    return tree


def to_numpy(params: Transformer) -> dict:
    """The port's parameters → the reference's pytree layout (numpy)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return array(node)

    return walk(to_tree(params))


def cache_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference cache pytree (numpy leaves) → the port's cache: contiguous
    ``{"layers": [{"k","v"[,scales]} or {"state","conv"}], "shared": [...]}``,
    or paged with the pools as the layers and the block table ``"bt"``
    beside them."""
    dev = resolve_device(device)

    def layer_t(layer):
        return {k: layer_t(v) if isinstance(v, dict) else tensor(v, dev)
                for k, v in layer.items()}

    out = {name: [layer_t(layer) for layer in tree[name]]
           for name in ("layers", "shared") if name in tree}
    if "bt" in tree:
        out["bt"] = tensor(tree["bt"], dev)
    return out


def cache_to_numpy(cache: dict) -> dict:
    def layer_np(layer):
        cand = "states_all" in layer     # a verify candidate: the reference's keys
        return {k: layer_np(v) if isinstance(v, dict) else array(v)
                for k, v in layer.items() if not (cand and k in ("state", "conv"))}

    out = {name: [layer_np(layer) for layer in cache[name]]
           for name in ("layers", "shared") if name in cache}
    if "bt" in cache:
        out["bt"] = array(cache["bt"])
    return out
