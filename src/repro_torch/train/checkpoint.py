"""Checkpointing: param/optimizer trees ↔ one ``.npz`` file — port of
``repro/train/checkpoint.py``, in its format: the tree is flattened to
``\\x1f``-joined key paths (``#i`` for a list index), written with
``np.savez`` to a temporary file and renamed into place, and rebuilt from
the paths on load (dicts and lists only).

Leaves may be torch tensors (on any device), numpy arrays or Python
scalars.  A bf16 leaf is written as the reference writes an
``ml_dtypes.bfloat16`` leaf: its 16-bit patterns as a 2-byte void array
(the same data bytes; the header says ``|V2`` where the reference's says
``<V2``, and numpy reads both back as ``|V2``), through a ``uint16`` view,
so no ``ml_dtypes`` is needed.  ``|V2`` is the only 2-byte void this format
produces, so :func:`load_checkpoint` returns it as it is and
``bridge.tensor`` reads it as bf16.  The reference's own loader cannot
read such a leaf (``jnp.asarray`` refuses ``|V2``): only its f32 trees
load there.

A :class:`~repro_torch.models.transformer.Transformer` goes in as the
reference's param layout: ``save_checkpoint(path, {"params":
bridge.to_tree(model), "step": n})``.
"""
from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

BF16_VOID = np.dtype("V2")


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).view(BF16_VOID)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":           # an ml_dtypes array from the reference
        return a.view(np.uint16).view(BF16_VOID)
    return a


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "\x1f" in str(k):
                raise ValueError(f"checkpoint keys may not contain \\x1f: {k!r}")
            out.update(_flatten(v, f"{prefix}{k}\x1f"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}\x1f"))
    else:
        out[prefix[:-1]] = _leaf(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("\x1f")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_checkpoint(path: str, tree) -> None:
    flat = _flatten(tree)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)     # atomic write: tmp + rename
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    finally:
        for t in (tmp, tmp + ".npz"):
            if os.path.exists(t):
                os.remove(t)


def load_checkpoint(path: str):
    """The saved tree, lists and dicts rebuilt, numpy leaves (bf16 as
    ``|V2``)."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
