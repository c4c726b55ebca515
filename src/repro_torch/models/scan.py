"""The reference's stacked ("scan") layout — port of ``repro/models/scan.py``'s
layout functions.

The reference runs its layers with ``jax.lax.scan`` over layer groups, so
that XLA compiles one copy of each distinct block kind; its train CLI
stores every model of more than 8 layers that way, so its full-width
checkpoints hold ``{"embed", "final_norm", "scan", ...}``.  Layer stacks are
grouped by their repeating pattern:

  dense/moe/ssm/audio : pattern [kind],            n = L
  vlm (llama-3.2)     : pattern [dense×4, cross],  n = L/5
  hybrid (zamba2)     : pattern [ssm×6] + shared,  n = L/6

The port runs no stacked forward: its counterpart of the compiled scan is
the decode step captured as a CUDA graph (``serving/graphs.py``), which
replays the per-layer launches with no host work between them.  So the
port keeps the per-layer layout, and this module converts both ways:
:func:`stack_params` / :func:`stack_cache` give the reference's layout
(``Model.to_scan``), :func:`unstack_params` / :func:`unstack_cache` take
it apart into the per-layer layout that ``bridge.from_jax_params`` and
``bridge.cache_from_numpy`` read.  Unstacking indexes the leading group
dim, so each layer's leaf is a view of the stacked array (numpy or torch)
and writes into a cache's views land in the stacked tensors.

Leaves may be torch tensors or numpy arrays (a loaded checkpoint).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import layer_kinds


def scan_pattern(cfg) -> Tuple[List[str], int, bool]:
    """(pattern kinds, n_groups, has_shared_block)."""
    kinds = layer_kinds(cfg)
    L = cfg.num_layers
    if cfg.arch_type == "hybrid" and cfg.attn_every:
        p = cfg.attn_every
        assert L % p == 0, (L, p)
        return kinds[:p], L // p, True
    if cfg.arch_type == "vlm" and cfg.cross_attn_every:
        p = cfg.cross_attn_every
        assert L % p == 0, (L, p)
        return kinds[:p], L // p, False
    return [kinds[0]], L, False


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def _stack(trees):
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs, dim=0)
        return np.stack([np.asarray(x) for x in xs], axis=0)

    return _map(stack, *trees)


def _unstack(tree, n: int) -> list:
    return [_map(lambda x, g=g: x[g], tree) for g in range(n)]


def stack_params(params: dict, cfg) -> dict:
    """Canonical (per-layer list) → scan layout."""
    pattern, n, _ = scan_pattern(cfg)
    P = len(pattern)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["scan"] = [_stack([params["layers"][g * P + j] for g in range(n)])
                   for j in range(P)]
    return out


def unstack_params(params: dict, cfg) -> dict:
    """Scan layout → canonical per-layer list layout, each leaf a view."""
    pattern, n, _ = scan_pattern(cfg)
    P = len(pattern)
    layers: list = [None] * (n * P)
    for j, grp in enumerate(params["scan"]):
        for g, layer in enumerate(_unstack(grp, n)):
            layers[g * P + j] = layer
    out = {k: v for k, v in params.items() if k != "scan"}
    out["layers"] = layers
    return out


def stack_cache(cache: dict, cfg) -> dict:
    pattern, n, shared = scan_pattern(cfg)
    P = len(pattern)
    out = {k: v for k, v in cache.items() if k not in ("layers", "shared")}
    out["scan"] = [_stack([cache["layers"][g * P + j] for g in range(n)])
                   for j in range(P)]
    if shared and "shared" in cache:
        out["shared"] = _stack(cache["shared"])
    return out


def unstack_cache(cache: dict, cfg) -> dict:
    """Scan layout → canonical list layout, each leaf a view."""
    pattern, n, shared = scan_pattern(cfg)
    P = len(pattern)
    layers: list = [None] * (n * P)
    for j, grp in enumerate(cache["scan"]):
        for g, layer in enumerate(_unstack(grp, n)):
            layers[g * P + j] = layer
    out = {"layers": layers}
    if shared and "shared" in cache:
        sh = cache["shared"]
        first = sh
        while isinstance(first, dict):
            first = next(iter(first.values()))
        out["shared"] = _unstack(sh, first.shape[0])
    return out
