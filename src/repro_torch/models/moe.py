"""Mixture-of-Experts FFN — port of the single-device path of
``repro/models/moe.py``.

Top-k routing, capacity-factor dispatch by gather, the batched expert FFN,
the gate-weighted combine, the Switch load-balance aux loss, and the
optional dense residual branch (arctic-480b).  The router stays f32 (its
path is in ``quant/apply._EXCLUDE``); the experts are
:class:`~repro_torch.models.linear.ExpertLinear` (E, din, dout) tensors,
quantized to W8A8 as a batch (``quant/int8.quantize_batched``) and run on
the card by one ``int8_matmul_batched`` launch per expert linear, which
takes each expert's kept rows (``route``'s ``fill``) and reads no weight of
an expert that keeps none.

Dispatch, exactly the reference's (``models/moe.py:206-262``): a stable
ranking of every (token, slot) within its expert's queue, ``keep = pos <
C`` for the static capacity ``C`` (:func:`capacity`), a slot → token map
scattered into an (E·C + 1) buffer whose last row is the sink of dropped
slots (the reference's ``mode="drop"``), and a gather of the tokens into
(E, C, D) (token n, a zero row, fills empty slots).  A dropped slot reads
its expert's row C-1 times a zero gate, as the reference's does.  At a
capacity factor below ``num_experts`` a token's output depends on what else
is in the batch (a slot past C is dropped); ``reduced()`` configs are
dropless.

On the card the routing must give a row the same bits whatever the row
count, and must be capturable into the decode step's CUDA graph
(``serving/graphs.py``):

* the f32 router product runs in fixed 256-row chunks
  (:func:`router_logits`), so one cuBLAS kernel with one reduction order
  computes every row;
* top-k is a stable descending sort of the probabilities: on ties the lower
  expert index wins, as ``jax.lax.top_k``'s does (``torch.topk`` promises
  no order);
* the combine sums the K weighted expert rows in f32 in the order
  k = 0 … K-1 and rounds once;
* ``C`` is host arithmetic on static shapes, and nothing syncs or makes a
  shape depend on a value (no ``bincount``, ``nonzero``, boolean indexing
  or ``.item()``).

Not ported: the TPU mesh's expert-parallel path (``_apply_moe_shard_map``,
``set_dispatch_spec``, ``set_shard_map``); the port runs on one card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import activation, dense_init, fixed_rows_matmul
from repro_torch.models.ffn import FFN
from repro_torch.models.linear import ExpertLinear, Linear
from repro_torch.quant.smoothquant import record_act_stats

ROUTER_ROWS = 256          # rows per router GEMM on the card (one shape, one kernel)


def capacity(n_tokens: int, num_experts: int, k: int, factor: float) -> int:
    return max(1, min(n_tokens * k,
                      math.ceil(n_tokens * k * factor / num_experts)))


def _rank_and_count(ids: torch.Tensor, n_bins: int):
    """(position of each element within its bin, by a stable sort; the
    elements of each bin, (n_bins + 1,) int64)."""
    nK = ids.shape[0]
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(nK, device=ids.device) - starts[ids[order]]
    return torch.empty_like(ids).scatter_(0, order, pos_sorted), counts


def rank_positions(ids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Position of each element within its bin, by a stable sort (the
    reference's ``_rank_positions``); ``ids`` (nK,) in ``[0, n_bins]``."""
    return _rank_and_count(ids, n_bins)[0]


def router_logits(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, D) rows × the f32 router (D, E) → (n, E) f32 logits.  On the card
    in zero-padded chunks of ROUTER_ROWS rows, each the same GEMM shape, so
    a row's logits do not depend on n (cuBLAS picks its kernel, and with it
    the reduction order, from M)."""
    return fixed_rows_matmul(xf.float(), w, ROUTER_ROWS)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, largest first, the
    lower index first among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(logits: torch.Tensor, k: int, num_experts: int, factor: float) -> dict:
    """The reference's routing and capacity dispatch of n tokens from their
    router logits (n, E): ``probs`` (n, E), ``gates`` (n, K) renormalised,
    ``eidx`` (n, K), ``pos`` (n, K) within the expert's queue, ``keep``
    (n, K), ``p_flat`` (nK,) the slot each (token, slot) reads (C-1 when
    dropped), ``slot_tok`` (E·C,) the token in each expert slot (n: empty),
    ``fill`` (E,) int32 the slots each expert keeps, min(count, C) (its
    rows 0 … fill-1 of the dispatch hold tokens, the rest the zero row),
    and the capacity ``C``."""
    n, E, K = logits.shape[0], num_experts, k
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, K)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    e_flat = eidx.reshape(-1)
    pos, counts = _rank_and_count(e_flat, E)
    pos = pos.view(n, K)
    C = capacity(n, E, K, factor)
    keep = pos < C
    keep_flat, pos_flat = keep.view(-1), pos.view(-1)
    p_flat = torch.where(keep_flat, pos_flat, C - 1)
    slot_ids = torch.where(keep_flat, e_flat * C + p_flat, E * C)   # E·C: the sink
    token_idx = torch.arange(n * K, device=logits.device) // K
    slot_tok = torch.full((E * C + 1,), n, dtype=torch.int64, device=logits.device)
    slot_tok = slot_tok.scatter_(0, slot_ids, token_idx)[:E * C]
    return dict(probs=probs, gates=gates, eidx=eidx, pos=pos, keep=keep, p_flat=p_flat,
                slot_tok=slot_tok, fill=counts[:E].clamp(max=C).to(torch.int32), C=C)


def _expert_linear(lin: nn.Module, x: torch.Tensor, collect=None, path: str = "",
                   rows: Optional[torch.Tensor] = None):
    """Batched expert GEMM x (E, C, din) → (E, C, dout), bf16 or W8A8,
    recording calibration stats over every gathered row (zero pad rows
    leave the maxima as they are).  ``rows``: each expert's kept rows (the
    W8A8 product writes +0 past them, the reference's product of the zero
    rows there; the combine reads none of them)."""
    if collect is not None:
        record_act_stats(collect, path, x.reshape(-1, x.shape[-1]))
    return lin(x, rows)


class MoE(nn.Module):
    """The MoE FFN of one layer: ``router`` (f32 (D, E)), ``up``/``gate``/
    ``down`` expert linears, and ``dense`` (arctic's residual FFN) — the
    reference pytree's keys, so calibration, quantization, the bridge and
    ``poison_params`` address the same leaves."""

    def __init__(self, cfg, router: Linear, up: nn.Module, down: nn.Module,
                 gate: Optional[nn.Module] = None, dense: Optional[FFN] = None):
        super().__init__()
        self.cfg = cfg
        self.router, self.up, self.down, self.gate, self.dense = router, up, down, gate, dense

    @classmethod
    def init(cls, generator, cfg, device):
        E, D, Fe, dt = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.dtype
        # the reference draws router, gate, up, down, dense from split keys
        router = Linear(dense_init(generator, (D, E), torch.float32, device))
        gate = ExpertLinear(dense_init(generator, (E, D, Fe), dt, device)) if cfg.glu else None
        up = ExpertLinear(dense_init(generator, (E, D, Fe), dt, device))
        down = ExpertLinear(dense_init(generator, (E, Fe, D), dt, device))
        dense = FFN.init(generator, cfg, device) if cfg.dense_residual else None
        return cls(cfg, router, up, down, gate, dense)

    def forward(self, x: torch.Tensor, collect=None, path: str = "",
                aux: Optional[list] = None) -> torch.Tensor:
        """x (B, T, D) → y (B, T, D); appends the layer's aux loss to
        ``aux`` when one is given (the decode step passes none)."""
        cfg = self.cfg
        B, T, D = x.shape
        E, K = cfg.num_experts, cfg.experts_per_token
        n = B * T
        xf = x.reshape(n, D)
        r = route(router_logits(xf, self.router.w), K, E, cfg.moe_capacity_factor)
        C = r["C"]
        xe = torch.cat([xf, xf.new_zeros(1, D)]).index_select(0, r["slot_tok"])
        xe = xe.view(E, C, D)

        fill = r["fill"]
        up = _expert_linear(self.up, xe, collect, f"{path}/up", fill)
        if self.gate is not None:
            h = activation(cfg, _expert_linear(self.gate, xe, collect, f"{path}/gate", fill)) * up
        else:
            h = activation(cfg, up)
        ye = _expert_linear(self.down, h, collect, f"{path}/down", fill)    # (E, C, D)

        # combine: each (token, slot)'s expert row times its gate (0 when
        # dropped), rounded to the model dtype as the reference's product is,
        # then summed over the K slots in f32 in slot order, rounded once
        e_flat = r["eidx"].reshape(-1)
        y_slots = ye.reshape(E * C, D).index_select(0, e_flat * C + r["p_flat"])
        w = (r["gates"] * r["keep"]).to(ye.dtype).reshape(n * K, 1)
        prod = (y_slots * w).view(n, K, D)
        acc = prod[:, 0].float()
        for k in range(1, K):
            acc = acc + prod[:, k]
        y = acc.to(x.dtype).view(B, T, D)

        if self.dense is not None:       # arctic's dense residual branch
            y = y + self.dense(x, collect, f"{path}/dense")
        if aux is not None:              # Switch load balance: E · Σ_e f_e · P_e
            f = F.one_hot(r["eidx"][:, 0], E).float().mean(dim=0)
            P = r["probs"].mean(dim=0)
            aux.append(E * (f * P).sum() * cfg.router_aux_coef)
        return y
