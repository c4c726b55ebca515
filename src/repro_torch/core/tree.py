"""Static token-tree templates for tree-style speculative decoding — port of
``repro/core/tree.py`` (the host-side numpy tables are the same).

One verifier forward scores a packed token tree instead of a chain: an
ancestor mask keeps every node conditioned on exactly its root-to-node
path, and verification commits the longest accepted root-to-leaf path.
The chain window is the degenerate single-branch tree, so the tree route
reduces bit-exactly to the chain route when ``branches == (1, ..., 1)``.

Packed node layout (BFS / level order): node 0 is the *root* — the last
committed token, never re-scored.  Level ``d`` holds ``prod(branches[:d])``
nodes, children of one parent adjacent.  The verify window is
``[last_committed, draft_1, ..., draft_{N-1}]`` with ``N = num_nodes``.

Tables (numpy, fixed per template):

* ``parents``  (N,) int32 — parent node, ``-1`` for the root.
* ``depths``   (N,) int32 — node positions are ``length - 1 + depth``.
* ``mask``     (N, N) bool — ancestor-or-self: ``mask[i, j]`` ⇔ node ``j``
  lies on the root→``i`` path (lower-triangular for a chain).
* ``mask_bits`` (N, ⌈N/32⌉) int32 — ``mask`` as bit words, bit ``j % 32``
  of word ``j // 32`` of row ``i``: what the ``flash_decode`` kernel reads.
* ``children`` (N, max_branch) int32 — child ids, ``-1`` padded, in
  verification order (child 0 of the root carries the chain proposal).
* ``paths``    (num_leaves, max_depth + 1) int32 — root→leaf node ids.
* ``src_leaf`` (N,) int32 — smallest leaf ordinal under each node.

Window node ``i`` writes its K/V at cache slot ``start + i`` while its RoPE
position is ``start + depth[i]``; after verification
:func:`repro_torch.models.transformer.commit_cache_tree` moves the accepted
path's rows into chain slots ``start .. start + n_accept``.

:meth:`TreeTemplate.on` gives the tables as torch tensors on a device,
built once per template and device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class TreeTables(NamedTuple):
    """A template's tables on one device."""

    depths: torch.Tensor      # (N,) int32
    mask: torch.Tensor        # (N, N) bool
    mask_bits: torch.Tensor   # (N, ⌈N/32⌉) int32
    parents: torch.Tensor     # (N,) int32
    children: torch.Tensor    # (N, max_branch) int64
    src_leaf: torch.Tensor    # (N,) int64


class TreeTemplate:
    """Immutable static token-tree topology (see module docstring)."""

    def __init__(self, branches: Tuple[int, ...]):
        branches = tuple(int(b) for b in branches)
        if any(b < 1 for b in branches):
            raise ValueError(f"branch factors must be >= 1, got {branches}")
        if int(np.prod([b for b in branches] or [1])) > 64:
            raise ValueError(f"template too wide: {branches} "
                             "(> 64 leaves)")
        self.branches = branches
        self._build()
        self._dev: Dict[torch.device, TreeTables] = {}

    @classmethod
    def chain(cls, gamma: int) -> "TreeTemplate":
        """The degenerate single-branch template: a γ-token chain."""
        if gamma < 0:
            raise ValueError(f"gamma must be >= 0, got {gamma}")
        return cls((1,) * gamma)

    # ------------------------------------------------------------------
    def _build(self) -> None:
        parents = [-1]
        depths = [0]
        frontier = [0]                       # node ids of the previous level
        for d, b in enumerate(self.branches, start=1):
            nxt = []
            for p in frontier:
                for _ in range(b):
                    nxt.append(len(parents))
                    parents.append(p)
                    depths.append(d)
            frontier = nxt
        N = len(parents)
        self.num_nodes = N
        self.max_depth = len(self.branches)
        self.max_branch = max(self.branches) if self.branches else 1
        self.parents = np.asarray(parents, np.int32)
        self.depths = np.asarray(depths, np.int32)

        # ancestor-or-self mask
        mask = np.zeros((N, N), bool)
        for i in range(N):
            j = i
            while j >= 0:
                mask[i, j] = True
                j = int(self.parents[j])
        self.mask = mask
        words = np.zeros((N, -(-N // 32)), np.uint32)
        for j in range(N):
            words[:, j // 32] |= mask[:, j].astype(np.uint32) << np.uint32(j % 32)
        self.mask_bits = words.view(np.int32)

        # children table, verification order == packed order
        children = np.full((N, self.max_branch), -1, np.int32)
        counts = np.zeros(N, np.int64)
        for i in range(1, N):
            p = int(self.parents[i])
            children[p, counts[p]] = i
            counts[p] += 1
        self.children = children

        # leaves (depth == max_depth) in packed order; root→leaf paths
        leaves = [i for i in range(N) if depths[i] == self.max_depth]
        self.num_leaves = len(leaves)
        self.leaves = np.asarray(leaves, np.int32)
        paths = np.zeros((self.num_leaves, self.max_depth + 1), np.int32)
        for li, leaf in enumerate(leaves):
            j = leaf
            for d in range(self.max_depth, -1, -1):
                paths[li, d] = j
                j = int(self.parents[j])
        self.paths = paths

        # representative leaf ordinal per node (smallest leaf under it)
        src_leaf = np.zeros(N, np.int32)
        for li in range(self.num_leaves - 1, -1, -1):
            for j in paths[li]:
                src_leaf[j] = li
        self.src_leaf = src_leaf

    # ------------------------------------------------------------------
    @property
    def gamma(self) -> int:
        """Draft tokens per window (everything but the root)."""
        return self.num_nodes - 1

    @property
    def is_chain(self) -> bool:
        return all(b == 1 for b in self.branches)

    def __repr__(self) -> str:
        return (f"TreeTemplate(branches={self.branches}, "
                f"nodes={self.num_nodes}, leaves={self.num_leaves})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeTemplate)
                and self.branches == other.branches)

    def __hash__(self) -> int:
        return hash(self.branches)

    def on(self, device) -> TreeTables:
        """The tables on ``device``, made at the first request and kept."""
        dev = torch.device(device)
        tables = self._dev.get(dev)
        if tables is None:
            tables = TreeTables(
                depths=torch.from_numpy(self.depths).to(dev),
                mask=torch.from_numpy(self.mask).to(dev),
                mask_bits=torch.from_numpy(self.mask_bits).to(dev),
                parents=torch.from_numpy(self.parents).to(dev),
                children=torch.from_numpy(self.children).long().to(dev),
                src_leaf=torch.from_numpy(self.src_leaf).long().to(dev))
            self._dev[dev] = tables
        return tables
