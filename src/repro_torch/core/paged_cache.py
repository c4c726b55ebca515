"""Paged (block-granular) KV cache: the scheduler's serving-path layout —
port of ``repro/core/paged_cache.py``.

* one **physical pool** per attention layer — ``(num_blocks, block_size,
  Hkv, dh)`` K and V buffers shared by every slot (int8 KV adds the
  per-(token, head) scale pools, same block granularity);
* one **block table** — ``(batch_slots, max_blocks)`` int32 mapping each
  slot's *logical* block ``s // block_size`` to a physical block id.
  Entry 0 is the reserved **scratch block**: unallocated table entries
  point at it, so out-of-range writes land in a block no request owns and
  out-of-range reads return junk that position masking discards;
* a host-side :class:`BlockPool` refcounting allocator (admission
  reserves a request's worst-case block demand, rows get blocks appended
  as they commit, harvest releases them), a :class:`PrefixIndex` over
  registered prompt blocks for **prefix sharing** (refcounted, with
  copy-on-write forks of a shared boundary block), and **preemption and
  swap** to host memory.

The host-side parts (``BlockPool``, ``PrefixIndex``, ``plan_group`` and
the sizing helpers) are copied from the reference.  The device helpers
are torch and update the pools **in place** (the reference returns new
pytrees): :func:`scatter_prefill_rows`, :func:`clone_block` and
:func:`swap_in_blocks` write into the tensors they are given.
:func:`swap_out_blocks` copies into pinned host tensors when the pool is
on the card (``pin_memory`` needs CUDA, so a CPU pool's snapshot is plain
host memory).

The decode step only reads logical slots that hold committed content or
that the current verify window just wrote, so block-granular allocation
(and the junk in fresh or scratch blocks) never reaches the logits.
:func:`gather_block_rows` reconstructs the logical view: it is the paged
attention's plain path on the CPU and the oracle of the
``flash_decode_paged`` kernel.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BLOCK_SIZE = 128    # tokens per block; 128 keeps pools lane-aligned
SCRATCH_BLOCK = 0           # physical block 0: never allocated, absorbs
#                             writes from idle rows / unallocated slots


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache rows (ceil division)."""
    return -(-int(n_tokens) // int(block_size))


def request_demand_tokens(prompt_len: int, max_new_tokens: int,
                          gamma: int) -> int:
    """Worst-case cache rows one request ever writes.

    The last verify window starts at ``length - 1`` with ``length`` at
    most ``prompt_len + max_new_tokens`` and spans ``gamma + 1`` slots,
    so the highest written row is ``P + max_new + gamma - 1``; +1 slack
    mirrors the contiguous buffer sizing.
    """
    return int(prompt_len) + int(max_new_tokens) + int(gamma) + 1


@dataclasses.dataclass
class _PrefixEntry:
    """One indexed block: ``tokens`` are the rows it vouches for."""

    key: str                 # rolling chain hash (content-addressed)
    parent: str              # parent chain hash ("" = chain root)
    block: int               # physical block id holding the rows
    tokens: Tuple[int, ...]  # registered rows, chain order (<= block_size)


class PrefixIndex:
    """Prefix-hash → block-chain index over registered prompt blocks.

    Keys are **rolling content hashes**: ``H(parent_key, block_tokens)``,
    so a chain of full blocks is addressed by its entire token prefix and
    two different prompts can never alias (an exact token comparison on
    every hit guards the astronomically-unlikely hash collision too).
    Entries come in two flavours sharing one namespace:

    * **full-block** entries (``len(tokens) == block_size``) — walked
      greedily by :meth:`lookup` as a chain;
    * **boundary** entries (``len(tokens) < block_size``) — the
      partially-filled last prefix block.  A lookup that exhausts the
      full chain scans the parent's children for the longest common
      token prefix, so a boundary (or full) entry can be *partially*
      matched — the sharer uses only the rows both prompts agree on.

    The index never owns blocks: :class:`BlockPool` calls
    :meth:`evict_block` the moment it reuses a cached-free block, which
    drops every entry describing it.  Orphaned descendants (parent
    evicted, child block still alive) become unreachable but revalidate
    for free if the same prefix is ever re-registered — content
    addressing makes the re-registered parent land on the same key.
    """

    ROOT = ""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._entries: Dict[str, _PrefixEntry] = {}
        self._children: Dict[str, List[str]] = {}
        self._by_block: Dict[int, List[str]] = {}
        # probe counters: NOTE the admission gate probes speculatively
        # (can_admit may run many times per admission), so ``lookups`` /
        # ``hits`` count *probes*; admission-level hit/miss rates live in
        # PagedGroup (one count per actually-admitted request)
        self.lookups = 0
        self.hits = 0            # probes returning >= 1 shared block
        self.hit_rows = 0        # cache rows covered across hit probes
        self.evictions = 0       # entries dropped via evict_block

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _hash(parent: str, tokens: Tuple[int, ...]) -> str:
        payload = parent.encode() + b"|" + ",".join(
            str(t) for t in tokens).encode()
        return hashlib.sha256(payload).hexdigest()

    def has_block(self, block: int) -> bool:
        return block in self._by_block

    def _add(self, key: str, parent: str, block: int,
             tokens: Tuple[int, ...]) -> None:
        self._entries[key] = _PrefixEntry(key, parent, block, tokens)
        self._children.setdefault(parent, []).append(key)
        self._by_block.setdefault(block, []).append(key)

    # ------------------------------------------------------------------
    def register(self, prompt: np.ndarray, block_ids: Sequence[int], *,
                 include_boundary: bool = True) -> None:
        """Index a freshly-admitted request's prefix blocks.

        ``prompt`` is the full (unpadded) prompt; only its prefill region
        ``prompt[:-1]`` is registered — the last prompt token opens the
        first verify window and its cache row is written later.
        ``block_ids`` is the request's block list in table order.
        Existing entries win (their blocks already hold the rows);
        ``include_boundary=False`` registers the full-block chain only —
        the admission path uses it when the pool is too tight to reserve
        the copy-on-write fork headroom a donated boundary block needs.
        """
        region = np.asarray(prompt).ravel()[:-1]
        bs = self.block_size
        parent, rows, i = self.ROOT, 0, 0
        while rows + bs <= region.size:
            tok = tuple(int(t) for t in region[rows: rows + bs])
            key = self._hash(parent, tok)
            if key not in self._entries:
                self._add(key, parent, int(block_ids[i]), tok)
            parent, rows, i = key, rows + bs, i + 1
        rem = tuple(int(t) for t in region[rows:])
        if rem and include_boundary and i < len(block_ids):
            key = self._hash(parent, rem)
            if key not in self._entries:
                self._add(key, parent, int(block_ids[i]), rem)

    def lookup(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``prompt``'s prefill region.

        Returns ``(block_ids, rows)``: the physical blocks holding the
        shared prefix (chain order; the last may be partially used) and
        the number of cache rows they cover.  ``rows`` is the admission
        prefill's warm frontier — rows ``[0, rows)`` are gathered from
        the pool, rows ``[rows, P - 1)`` are the cold tail.
        """
        region = np.asarray(prompt).ravel()[:-1]
        bs = self.block_size
        ids: List[int] = []
        rows, parent = 0, self.ROOT
        while rows + bs <= region.size:
            tok = tuple(int(t) for t in region[rows: rows + bs])
            key = self._hash(parent, tok)
            e = self._entries.get(key)
            if e is None or e.tokens != tok:
                break
            ids.append(e.block)
            rows, parent = rows + bs, key
        rem = tuple(int(t) for t in region[rows:])
        if rem:
            best_m, best = 0, None
            for ck in self._children.get(parent, ()):
                e = self._entries.get(ck)
                if e is None:
                    continue
                lim = min(len(e.tokens), len(rem))
                m = 0
                while m < lim and e.tokens[m] == rem[m]:
                    m += 1
                # longest match wins; block id breaks ties determin-
                # istically so repeated lookups share the same donor
                if m > best_m or (m == best_m and m > 0
                                  and best is not None
                                  and e.block < best.block):
                    best_m, best = m, e
            if best_m > 0:
                ids.append(best.block)
                rows += best_m
        self.lookups += 1
        if ids:
            self.hits += 1
            self.hit_rows += rows
        return ids, rows

    def evict_block(self, block: int) -> None:
        """Drop every entry describing ``block`` (its content is about
        to be overwritten by a new owner)."""
        for key in self._by_block.pop(block, []):
            e = self._entries.pop(key, None)
            if e is not None:
                self.evictions += 1
                kids = self._children.get(e.parent)
                if kids is not None and key in kids:
                    kids.remove(key)


class BlockPool:
    """Host-side refcounting allocator for the physical block pool.

    Over ``num_blocks - 1`` allocatable blocks (block 0 is scratch) every
    block is in exactly one of three states:

    * **free** — on the free list, owned by nobody, not indexed;
    * **cached-free** — owned by nobody but still described by the
      :class:`PrefixIndex` (resurrectable via :meth:`share`); reused in
      LRU order when the free list runs dry, which evicts its entries;
    * **referenced** — held by ``refcount >= 1`` requests.  A block with
      ``refcount > 1`` is *shared*: it appears in several requests'
      block tables and is freed only when the last reference drops.

    Reservations guarantee appends: :meth:`reserve` books worst-case
    *fresh-block* demand per request and :meth:`alloc` / :meth:`cow` may
    only draw up to it.  The admission gate is the **slack** — free
    blocks minus every request's still-undrawn reservation — so sharing
    an already-referenced block costs nothing, resurrecting a
    cached-free one costs one slack unit, and without sharing the gate
    is provably the legacy ``reserved + n <= capacity`` rule.

    Invariants (property-tested against the reference in
    ``tests/test_torch_paged.py``):

    * ``free + cached + unique_allocated == num_blocks - 1`` (no leak);
    * per-block refcount equals the number of owning requests' tables
      it appears in; blocks free only at refcount zero;
    * the scratch block is never allocated, shared or refcounted;
    * ``drawn <= reserved`` per request and ``slack >= 0`` — admission
      control is sound, mid-flight appends and COW forks never fail.
    """

    def __init__(self, num_blocks: int, block_size: int = DEFAULT_BLOCK_SIZE,
                 prefix: Optional[PrefixIndex] = None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 scratch + 1 usable), "
                             f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix = prefix
        # LIFO free list: recently released blocks are re-used first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU
        self._ref: Dict[int, int] = {}              # block -> refcount
        self._owned: Dict[int, List[int]] = {}      # rid -> table order
        self._reserved: Dict[int, int] = {}         # rid -> fresh budget
        self._drawn: Dict[int, int] = {}            # rid -> fresh drawn
        self._swapped: set = set()                  # rids evicted to host
        self.peak_allocated = 0                     # high-water unique blocks
        # fault-injection seam (serving/faults.py): called with the draw
        # size before alloc() touches the free list, so an injected
        # failure is atomic — it may raise, the pool keeps no partial
        # state.  None (the default) costs one attribute load.
        self.fault_hook = None
        # monotone event counters (observability: ServerMetrics kv_cache
        # section aggregates these through PagedGroup.snapshot)
        self.counters: Dict[str, int] = {
            "alloc_blocks": 0,       # fresh draws (alloc + COW forks)
            "freed_blocks": 0,       # refcount reached zero
            "resurrections": 0,      # cached-free blocks shared back in
            "cached_evicted": 0,     # cached-free blocks reclaimed by _draw
            "cow_forks": 0,          # shared blocks forked for a writer
            "swap_out_blocks": 0,    # blocks released via swap_out
        }

    # -- capacity ------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the scratch block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Blocks owned by nobody (plain free + cached-free)."""
        return len(self._free) + len(self._cached)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def reserved_blocks(self) -> int:
        return sum(self._reserved.values())

    @property
    def allocated_blocks(self) -> int:
        """Block-table entries across requests (shared blocks counted
        once per sharer — the logical footprint)."""
        return sum(len(b) for b in self._owned.values())

    @property
    def unique_allocated(self) -> int:
        """Distinct referenced blocks (the physical footprint)."""
        return len(self._ref)

    @property
    def slack(self) -> int:
        """Free blocks not yet promised to any admitted request."""
        undrawn = sum(self._reserved[r] - self._drawn[r]
                      for r in self._reserved)
        return self.free_blocks - undrawn

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for_tokens(n_tokens, self.block_size)

    def ref(self, block: int) -> int:
        """Current refcount of ``block`` (0 = free or cached-free)."""
        return self._ref.get(int(block), 0)

    # -- lifecycle -----------------------------------------------------
    def can_reserve(self, n_blocks: int) -> bool:
        """Admission check: does a further ``n_blocks`` fresh-block
        reservation fit?  Equivalent to the legacy ``reserved + n <=
        capacity`` gate when nothing is shared or cached."""
        return int(n_blocks) <= self.slack

    def reserve(self, rid: int, n_blocks: int) -> None:
        """Book worst-case fresh-block demand for ``rid`` at admission
        (also the swap-in re-admission path: clears the swapped mark)."""
        if rid in self._reserved:
            raise ValueError(f"request {rid} already reserved")
        if not self.can_reserve(n_blocks):
            raise ValueError(
                f"pool over-committed: reserve({n_blocks}) with "
                f"slack {self.slack}")
        self._reserved[rid] = int(n_blocks)
        self._drawn[rid] = 0
        self._owned.setdefault(rid, [])
        self._swapped.discard(rid)

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, []))

    def _draw(self) -> int:
        """Pop one free block, evicting a cached-free block (LRU, index
        entries dropped) when the plain free list is dry."""
        if self._free:
            return self._free.pop()
        if self._cached:
            block, _ = self._cached.popitem(last=False)
            if self.prefix is not None:
                self.prefix.evict_block(block)
            self.counters["cached_evicted"] += 1
            return block
        raise RuntimeError(      # unreachable if reservations are honoured
            "free list exhausted (reservation accounting broken)")

    def _note_peak(self) -> None:
        if len(self._ref) > self.peak_allocated:
            self.peak_allocated = len(self._ref)

    def alloc(self, rid: int, n_blocks: int) -> List[int]:
        """Draw ``n_blocks`` fresh blocks for ``rid`` (<= its
        reservation; admission control makes this infallible)."""
        if rid not in self._reserved:
            raise ValueError(f"request {rid} has no reservation")
        have = self._drawn[rid]
        if have + n_blocks > self._reserved[rid]:
            raise ValueError(
                f"request {rid} alloc beyond reservation: "
                f"{have}+{n_blocks} > {self._reserved[rid]}")
        if self.fault_hook is not None and n_blocks:
            self.fault_hook(int(n_blocks))    # may raise InjectedFault
        ids = [self._draw() for _ in range(int(n_blocks))]
        for b in ids:
            self._ref[b] = 1
        self._owned[rid].extend(ids)
        self._drawn[rid] += int(n_blocks)
        self.counters["alloc_blocks"] += int(n_blocks)
        self._note_peak()
        return ids

    def share(self, rid: int, block_ids: Sequence[int]) -> None:
        """Append already-stored prefix blocks to ``rid``'s table.

        Referenced blocks just gain a reference; cached-free blocks are
        resurrected (costing one slack unit each — the admission gate
        must have accounted for them).  Never draws a fresh block, so it
        does not count against ``rid``'s reservation.
        """
        if rid not in self._reserved:
            raise ValueError(f"request {rid} has no reservation")
        for b in block_ids:
            b = int(b)
            if b == SCRATCH_BLOCK:
                raise ValueError("scratch block can never be shared")
            if b in self._ref:
                self._ref[b] += 1
            elif b in self._cached:
                if self.slack < 1:
                    raise RuntimeError(
                        f"resurrecting cached block {b} would break a "
                        "running request's append guarantee (admission "
                        "gate under-counted)")
                del self._cached[b]
                self._ref[b] = 1
                self.counters["resurrections"] += 1
            else:
                raise ValueError(f"block {b} is not shareable "
                                 "(free or unknown)")
            self._owned[rid].append(b)
        self._note_peak()

    def cow(self, rid: int, block: int) -> int:
        """Copy-on-write fork: make ``rid``'s table entry for ``block``
        privately writable.

        Sole owner → the block itself (write in place).  Shared → one
        reference is moved to a freshly drawn block (counted against
        ``rid``'s reservation) and the new id returned; the caller must
        copy the device content (:func:`clone_block`) and patch its
        block table.  Other sharers keep the original untouched.
        """
        block = int(block)
        if self._ref.get(block, 0) < 1:
            raise ValueError(f"block {block} is not allocated")
        if block not in self._owned.get(rid, ()):
            raise ValueError(f"request {rid} does not own block {block}")
        if self._ref[block] == 1:
            return block
        if self._drawn[rid] + 1 > self._reserved[rid]:
            raise ValueError(
                f"request {rid} COW fork beyond reservation "
                f"({self._reserved[rid]} blocks)")
        new = self._draw()
        self._ref[new] = 1
        self._ref[block] -= 1
        self._drawn[rid] += 1
        self.counters["alloc_blocks"] += 1
        self.counters["cow_forks"] += 1
        owned = self._owned[rid]
        owned[owned.index(block)] = new
        self._note_peak()
        return new

    def _unref(self, block: int) -> None:
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            self.counters["freed_blocks"] += 1
            if self.prefix is not None and self.prefix.has_block(block):
                self._cached[block] = None      # resurrectable, LRU order
            else:
                self._free.append(block)

    def swap_out(self, rid: int) -> List[int]:
        """Evacuate ``rid``: drop every table reference and the whole
        reservation, freeing its capacity *now*; mark the request
        swapped so a racing :meth:`release` is a no-op.  Returns the
        table (the engine snapshots the block content to host memory
        *before* calling this).  Resume = :meth:`reserve` +
        :meth:`alloc` + copy-back."""
        if rid not in self._reserved:
            raise ValueError(f"request {rid} has no reservation")
        ids = self._owned.pop(rid, [])
        for b in ids:
            self._unref(b)
        self._reserved.pop(rid, None)
        self._drawn.pop(rid, None)
        self._swapped.add(rid)
        self.counters["swap_out_blocks"] += len(ids)
        return ids

    def release(self, rid: int) -> List[int]:
        """Drop every reference ``rid`` holds and its reservation.

        Exactly-once guarantee: a request that was swapped out already
        returned its blocks in :meth:`swap_out`, so releasing it (a
        finish or shed racing the eviction) frees nothing and returns
        ``[]``.  Otherwise it returns every block ``rid`` referenced,
        also those another request still holds (the reference's return
        value, kept as it is; callers read refcounts, not this list).
        """
        if rid in self._swapped:
            self._swapped.discard(rid)
            self._owned.pop(rid, None)
            self._reserved.pop(rid, None)
            self._drawn.pop(rid, None)
            return []
        ids = self._owned.pop(rid, [])
        self._reserved.pop(rid, None)
        self._drawn.pop(rid, None)
        for b in reversed(ids):
            self._unref(b)
        return ids

    def check_invariants(self) -> None:
        """Raise if conservation, refcounting or exclusivity breaks."""
        owned_all = [b for ids in self._owned.values() for b in ids]
        counts: Dict[int, int] = {}
        for b in owned_all:
            counts[b] = counts.get(b, 0) + 1
        assert counts == self._ref, (
            f"refcounts drifted from ownership: {self._ref} != {counts}")
        assert SCRATCH_BLOCK not in counts, "scratch block allocated"
        assert SCRATCH_BLOCK not in self._free, "scratch block on free list"
        assert SCRATCH_BLOCK not in self._cached, "scratch block cached"
        assert not (set(self._free) & set(self._cached)), (
            "block both free and cached")
        assert len(self._free) + len(self._cached) + len(self._ref) \
            == self.capacity, (
                f"pool not conserved: {len(self._free)} free + "
                f"{len(self._cached)} cached + {len(self._ref)} allocated "
                f"!= {self.capacity}")
        assert self.slack >= 0, "append guarantee broken (negative slack)"
        for rid in self._reserved:
            assert self._drawn[rid] <= self._reserved[rid], (
                f"request {rid} drew beyond reservation")
        for rid in self._swapped:
            assert not self._owned.get(rid) and rid not in self._reserved, (
                f"swapped request {rid} still owns blocks")


# ---------------------------------------------------------------------------
# Device-side layout helpers (torch, in place)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, batch_slots: int, max_blocks: int,
                     num_blocks: int, block_size: int = DEFAULT_BLOCK_SIZE,
                     num_layers: Optional[int] = None, device="cuda") -> dict:
    """Allocate the paged serving cache.

    Returns ``{"layers": [per-layer pools], "bt": (B, max_blocks) int32}``
    where each layer pool is ``{"k", "v": (num_blocks, block_size, Hkv,
    dh)}`` (+ ``k_scale``/``v_scale`` ``(num_blocks, block_size, Hkv)``
    f32 when ``cfg.kv_cache_dtype == "int8"``).  Pools start zeroed (a
    masked slot still enters p·V with p = 0, and 0·NaN = NaN) and the
    block table all-scratch (0).  Dense decoder stacks only — the engine
    gates other families off before building one.
    """
    int8 = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if int8 else cfg.dtype
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    layers = []
    for _ in range(num_layers or cfg.num_layers):
        pool = {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
        if int8:
            pool["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            pool["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        layers.append(pool)
    return {"layers": layers,
            "bt": torch.zeros((batch_slots, max_blocks), dtype=torch.int32, device=device)}


def physical_slots(bt: torch.Tensor, slots: torch.Tensor,
                   block_size: int) -> torch.Tensor:
    """Map logical cache slots to physical pool rows.

    ``bt`` is ``(B, max_blocks)`` int32, ``slots`` is ``(B, T)`` logical
    slot indices; returns ``(B, T)`` int64 rows into the pool viewed as
    ``(num_blocks * block_size, ...)``.  A slot past the row's table maps
    to the scratch block (never to a wrapped or clipped live block).
    """
    nb = bt.shape[1]
    logical = slots.long() // block_size
    blk = torch.gather(bt, 1, logical.clamp(0, nb - 1)).long()
    blk = torch.where(logical < nb, blk, SCRATCH_BLOCK)
    return blk * block_size + slots.long() % block_size


def gather_block_rows(pool_buf: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Reconstruct the logical contiguous view of one pool buffer.

    ``pool_buf`` is ``(num_blocks, block_size, ...)``; returns
    ``(B, max_blocks * block_size, ...)`` where logical slot ``s`` of
    row ``b`` holds ``pool_buf[bt[b, s // bs], s % bs]``.  The paged
    attention's plain path and the ``flash_decode_paged`` oracle.
    """
    B, nb = bt.shape
    bs = pool_buf.shape[1]
    g = pool_buf[bt.reshape(-1).long()]                     # (B*nb, bs, ...)
    return g.reshape((B, nb * bs) + tuple(pool_buf.shape[2:]))


def _index(block_ids: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(block_ids, np.int64), device=device)


def scatter_prefill_rows(pool: dict, block_ids: Sequence[int],
                         row_cache: dict, block_size: int,
                         first_block: int = 0) -> dict:
    """Scatter a single-row *contiguous* prefill cache into pool blocks,
    in place.

    ``row_cache`` leaves are ``(1, S_row, ...)``; contiguous rows
    starting at logical block ``first_block`` (zero-padded if the
    contiguous row is shorter) land in the listed physical blocks, i.e.
    ``block_ids[i]`` receives rows ``[(first_block + i) * bs, ...)``.
    Writing the fresh-init-plus-prefill content into every owned
    (non-shared) block is what keeps slot recycling leak-free, like the
    contiguous row reset.  Returns ``pool``.
    """
    n = len(block_ids)
    if n == 0:
        return pool
    lo = int(first_block) * block_size
    need = lo + n * block_size
    for name, buf in pool.items():
        row = row_cache[name][0]                             # (S_row, ...)
        if row.shape[0] < need:
            pad = row.new_zeros((need - row.shape[0],) + tuple(row.shape[1:]))
            row = torch.cat([row, pad])
        vals = row[lo:need].reshape((n, block_size) + tuple(row.shape[1:]))
        buf[_index(block_ids, buf.device)] = vals.to(buf.dtype)
    return pool


def clone_block(layers: Sequence[dict], src: int, dst: int) -> Sequence[dict]:
    """Copy every pool tensor's ``src`` block into ``dst``, in place (the
    device half of a COW fork; ``BlockPool.cow`` is the host half)."""
    for pool in layers:
        for buf in pool.values():
            buf[dst] = buf[src]
    return layers


def swap_out_blocks(layers: Sequence[dict],
                    block_ids: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
    """Snapshot the listed physical blocks of every layer pool to host
    memory (the swap pool): pinned tensors for a pool on the card.  Exact
    for every pool dtype — int8 KV swaps the codes *and* the f32 scale
    pools."""
    out = []
    for pool in layers:
        snap = {}
        for name, buf in pool.items():
            rows = buf[_index(block_ids, buf.device)]
            host = torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=buf.device.type == "cuda")
            host.copy_(rows)
            snap[name] = host
        out.append(snap)
    return out


def swap_in_blocks(layers: Sequence[dict], block_ids: Sequence[int],
                   host: Sequence[Dict[str, torch.Tensor]]) -> Sequence[dict]:
    """Copy a :func:`swap_out_blocks` snapshot back into (possibly
    different) physical blocks, in place."""
    if not block_ids:
        return layers
    for pool, snap in zip(layers, host):
        for name, buf in pool.items():
            buf[_index(block_ids, buf.device)] = snap[name].to(buf.device, buf.dtype)
    return layers


# ---------------------------------------------------------------------------
# Modeled footprint
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """Static sizing decisions for one paged serving group."""

    block_size: int
    max_blocks: int          # block-table width (= ceil(buf / block_size))
    num_blocks: int          # physical pool size, incl. the scratch block
    slots: int               # decode rows (dynamic batch_slots)
    demands: tuple           # per-request block demand, request order


def plan_group(prompt_lens: Sequence[int], budgets: Sequence[int],
               gamma: int, buf: int, *, block_size: int,
               pool_blocks: Optional[int] = None,
               batch_slots: Optional[int] = None,
               default_slots: int = 8, max_slots: int = 64) -> PagedPlan:
    """Size the pool and pick the slot count for one serving group.

    * per-request demand = worst-case rows / ``block_size`` (ceil);
    * ``pool_blocks`` defaults to scratch + the ``min(len, default_slots)``
      *largest* demands — capacity comparable to the contiguous layout's
      default slot count, so paged never regresses admission;
    * ``slots`` (when not forced via ``batch_slots``) is **occupancy-
      derived**: the largest number of queued requests whose demands
      can actually be co-reserved (greedy, cheapest-first) — short-
      request mixes get more concurrent rows out of the same HBM than
      the contiguous layout's fixed worst-case sizing (the ROADMAP's
      admission-aware slot sizing), capped at ``max_slots``, and never
      inflated by rows the admission control could never co-house.
    """
    demands = tuple(
        blocks_for_tokens(request_demand_tokens(p, b, gamma), block_size)
        for p, b in zip(prompt_lens, budgets))
    n = len(demands)
    if pool_blocks is None:
        cap = default_slots if batch_slots is None else batch_slots
        top = sorted(demands, reverse=True)[: min(n, cap)]
        pool_blocks = 1 + sum(top)
    if max(demands) > pool_blocks - 1:
        raise ValueError(
            f"request demand {max(demands)} blocks exceeds pool capacity "
            f"{pool_blocks - 1}; raise kv_pool_blocks or shrink the request")
    if batch_slots is not None:
        slots = min(n, batch_slots)
    else:
        # greedy cheapest-first fill: how many queued requests could the
        # pool co-reserve at once?  (an upper bound on live rows — using
        # min-demand alone would allocate decode rows that admission
        # control can never co-house)
        fit, room = 0, pool_blocks - 1
        for d in sorted(demands):
            if d > room:
                break
            fit, room = fit + 1, room - d
        slots = min(n, max_slots, max(1, fit))
    return PagedPlan(block_size=block_size,
                     max_blocks=blocks_for_tokens(buf, block_size),
                     num_blocks=pool_blocks, slots=slots, demands=demands)
