"""Logical-axis sharding rules with a divisibility fallback — port of
``repro/launch/sharding.py``.

Every rule checks that the tensor dim divides the mesh-axis product before
sharding it; otherwise the dim is replicated (smollm's 9 heads, whisper's
51865 vocab, mamba2's 50280 vocab need no special case).

  column-parallel (out-dim on "model"):  attn q/k/v, ffn up/gate, ssm in_proj
  row-parallel    (in-dim on "model"):   attn o, ffn down, ssm out_proj
  expert-parallel ("model" on E):        moe up/gate/down  (E, din, dout)
  vocab-parallel  ("model" on V):        embed, lm_head out-dim
  FSDP (optional, train):                remaining large dim over data axes

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
names, or ``None`` (replicated) — the reference's ``PartitionSpec``.
:func:`placements` turns one into DTensor placements on a mesh.

The rules are the reference's, over the reference's shapes.  The port
stores prepared weights transposed: ``w_int8`` (N, K) where the reference
holds (K, N), ``w_int4`` (N, K/2), experts (E, N, K) (``models/linear.py``).
:func:`port_param_spec` swaps such a leaf's last two dims before it asks the
rule and swaps the spec back, so a leaf is split on the same logical
dimension as the reference's.
"""
from __future__ import annotations

import math
import re
from typing import Optional

from repro_torch.launch.mesh import axis_sizes, data_axes

_TRANSPOSED = ("w_int8", "w_int4")


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fit(mesh, dim: int, axes):
    """Return ``axes`` if dim divides their product, else None (replicate).
    Single-axis tuples are unwrapped to the bare axis name."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    sz = _axsize(mesh, axes)
    if not (sz > 1 and dim % sz == 0):
        return None
    return axes[0] if len(axes) == 1 else axes


def _col(mesh, shape, fsdp):
    """(din, dout) column-parallel: out on model, din on fsdp."""
    return (_fit(mesh, shape[0], fsdp), _fit(mesh, shape[1], "model"))


def _row(mesh, shape, fsdp):
    """(din, dout) row-parallel: din on model, out on fsdp."""
    return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], fsdp))


def _expert(mesh, shape, fsdp):
    """(E, din, dout): experts on model, din on fsdp."""
    e = _fit(mesh, shape[0], "model")
    if e is None:  # few experts: fall back to tensor-parallel inside experts
        return (None, None, _fit(mesh, shape[2], "model"))
    return (e, _fit(mesh, shape[1], fsdp), None)


# path fragments → rule; order matters (first match wins)
_COLUMN = ("/q/", "/k/", "/v/", "gate/", "up/", "in_proj", "router")
_ROW = ("/o/", "down/", "out_proj")


def _param_spec(path: str, shape, mesh, fsdp) -> tuple:
    """The reference's rule for a leaf of the reference's shape."""
    nd = len(shape)
    path = path + "/"
    if "scan/" in path and nd >= 1:
        # stacked layer-group leaf: leading L dim replicated, inner rule applies
        inner = _param_spec(path.replace("scan/", "layers/"), shape[1:], mesh, fsdp)
        return (None, *inner)
    if nd == 0:
        return ()
    if nd == 1:
        # bias/scale vectors: shard only column-parallel outputs
        if any(t in path for t in _COLUMN) and ("/b/" in path or "w_scale" in path):
            return (_fit(mesh, shape[0], "model"),)
        return ()
    if "embed" in path:
        v = _fit(mesh, shape[0], "model")
        return (v, _fit(mesh, shape[1], fsdp if v else "model"))
    if "lm_head" in path:
        return _col(mesh, shape, fsdp)
    if nd == 3 and ("moe" in path or shape[0] <= 256 and (
            "up/" in path or "gate/" in path or "down/" in path)):
        if "w_scale" in path:  # (E, dout)
            return (_fit(mesh, shape[0], "model"), None)
        return _expert(mesh, shape, fsdp)
    if nd == 2 and "w_scale" in path:
        return (_fit(mesh, shape[0], "model"), None)
    if "conv_w" in path:
        return (None, _fit(mesh, shape[1], "model"))
    if any(t in path for t in _ROW):
        return _row(mesh, shape, fsdp)
    if any(t in path for t in _COLUMN):
        return _col(mesh, shape, fsdp)
    return ()


def _swap_last(seq) -> tuple:
    seq = tuple(seq)
    return (*seq[:-2], seq[-1], seq[-2])


def port_param_spec(path: str, shape, mesh, fsdp=None) -> tuple:
    """The rule for a leaf of the port's shape: a transposed int8/int4
    weight is asked as the reference's layout and its spec swapped back.
    A replicated leaf's spec is ``()``, as the reference's ``P()``."""
    if path.rsplit("/", 1)[-1] in _TRANSPOSED and len(shape) >= 2:
        spec = _param_spec(path, _swap_last(shape), mesh, fsdp)
        return _swap_last(spec) if len(spec) == len(shape) else spec
    return _param_spec(path, tuple(shape), mesh, fsdp)


def tree_paths(tree, prefix: str = ""):
    """``[(path, tensor)]`` of a nested dict/list of tensors, the
    reference's ``"/"``-joined key paths (list items by index); leaves that
    are no tensor (the rows' ``torch.Generator``\\ s) are left out."""
    import torch

    if isinstance(tree, dict):
        return [pt for k, v in tree.items() for pt in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pt for i, v in enumerate(tree) for pt in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)] if isinstance(tree, torch.Tensor) else []


def param_leaves(params):
    """``[(path, tensor)]`` of a parameter tree: a ``Transformer`` (its
    buffers by reference path) or a nested dict/list of tensors."""
    from torch import nn

    if isinstance(params, nn.Module):
        from repro_torch.models.transformer import param_leaves as leaves

        return [(path, t) for path, _, _, t in leaves(params)]
    return tree_paths(params)


def param_shardings(params, mesh, fsdp: Optional[tuple] = None) -> dict:
    """``{path: spec}`` for every leaf of ``params``."""
    return {path: port_param_spec(path, tuple(t.shape), mesh, fsdp)
            for path, t in param_leaves(params)}


# ---------------------------------------------------------------------------
# Activation / engine-state shardings
# ---------------------------------------------------------------------------

def _state_spec(path: str, shape, mesh, dp) -> tuple:
    nd = len(shape)
    stacked = "scan/" in path or (
        "shared/" in path and not re.search(r"shared/\d+/", path + "/"))
    if stacked and nd >= 1:
        # stacked per-layer cache: leading L dim replicated
        inner = _state_spec(path.replace("scan/", "st/").replace("shared/", "st/"),
                            shape[1:], mesh, dp)
        return (None, *inner)
    b = _fit(mesh, shape[0], dp) if nd >= 1 else None
    if nd == 0:
        return ()
    if "states_all" in path:                  # (B, T, H, P, N)
        return (b, None, _fit(mesh, shape[2], "model"), None, None)
    # SSD state leaf only — "drafter_state/…" prefixes must not match
    if (path.endswith("/state") or path == "state") and nd == 4:
        return (b, _fit(mesh, shape[1], "model"), None, None)
    if "conv" in path and nd == 3:            # (B, K-1, convdim)
        return (b, None, _fit(mesh, shape[2], "model"))
    if nd == 4:                               # KV cache (B, S, Hkv, dh)
        h = _fit(mesh, shape[2], "model")
        d = None if h else _fit(mesh, shape[3], "model")
        return (b, None, h, d)
    if nd == 3:                               # embeddings (B, S, D)
        return (b, None, _fit(mesh, shape[2], "model"))
    if nd == 2:                               # tokens/kpos (B, S)
        return (b, None)
    if nd == 1 and shape[0] > 2:              # length/commits (B,)
        return (b,)
    return ()


def state_shardings(state, mesh) -> dict:
    """``{path: spec}`` for the serve-engine state (tokens/length/cache/…)."""
    dp = data_axes(mesh)
    return {path: _state_spec(path, tuple(t.shape), mesh, dp)
            for path, t in tree_paths(state)}


def batch_shardings(batch, mesh) -> dict:
    """{"tokens": (B,T), "labels": (B,T) [, "aux_embeds": (B,S,D)]}: the
    batch dim on the data axes."""
    dp = data_axes(mesh)
    return {path: (_fit(mesh, t.shape[0], dp), *([None] * (t.dim() - 1)))
            for path, t in tree_paths(batch)}


def shard_factor(spec, mesh) -> int:
    """How many ways a leaf with ``spec`` is split: the product of the
    sizes of the axes it names."""
    names = []
    for entry in spec:
        if entry is not None:
            names.extend((entry,) if isinstance(entry, str) else entry)
    return _axsize(mesh, tuple(names)) if names else 1


def bytes_per_card(leaves, specs: dict, mesh) -> int:
    """Σ over ``[(path, tensor)]`` of its bytes over its shard factor."""
    return sum(t.numel() * t.element_size() // shard_factor(specs[path], mesh)
               for path, t in leaves)


def placements(spec, mesh) -> list:
    """DTensor placements of a leaf with ``spec`` on ``mesh``: for each mesh
    dim, ``Shard(d)`` where tensor dim ``d`` names that axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple) and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
