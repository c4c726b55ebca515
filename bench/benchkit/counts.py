"""The benchmark's frozen roofline arithmetic: one NVIDIA H100's published
peaks, and the operations and bytes of each piece of work counted from
shapes and the live rows.

A copy of the arithmetic of ``repro_torch/launch/roofline.py`` (PR 23),
reworked to count from a configuration's sizes instead of the program's
parameter tree, so that the yardstick stays as it is whatever later
changes the program.  Every byte is counted once, as the least the card
must move for the work these inputs need: rows past a request's prompt
(padding) and idle slots are not counted.  Dense models: an MoE
configuration brings counts of its own.

Peaks (NVIDIA H100 SXM data sheet, dense rates, 700 W): 989 TFLOP/s bf16,
1979 TOP/s int8, 3.35 TB/s HBM.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BW = 3.35e12                   # B/s


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes the counts need, from a configuration file's ``model``."""

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    @classmethod
    def of(cls, model: dict) -> "Dims":
        hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
        return cls(model["num_layers"], model["d_model"], model["num_heads"],
                   model["num_kv_heads"], hd, model["d_ff"], model["vocab_size"])

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def dense_linears(self, logits: bool = True):
        """(din, dout) of every int8 linear, all layers; ``lm_head`` when
        ``logits``."""
        D = self.d_model
        per = [(D, self.q_dim), (D, self.kv_dim), (D, self.kv_dim), (self.q_dim, D),
               (D, self.d_ff), (D, self.d_ff), (self.d_ff, D)]
        out = per * self.num_layers
        if logits:
            out.append((D, self.vocab_size))
        return out

    def weight_params(self) -> int:
        """Raw parameters: embedding, every linear, norms."""
        D = self.d_model
        n = 2 * self.vocab_size * D + sum(a * b for a, b in self.dense_linears(False))
        return n + (2 * self.num_layers + 1) * D

    def kv_bytes_per_token(self) -> int:
        """Bytes of one token's K and V rows over every layer, bf16."""
        return 2 * self.kv_dim * 2 * self.num_layers


@dataclasses.dataclass
class Work:
    """Operations (int8 and bf16) and bytes of some work."""

    int8_ops: float = 0.0
    bf16_ops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.int8_ops + o.int8_ops, self.bf16_ops + o.bf16_ops,
                    self.nbytes + o.nbytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.int8_ops * k, self.bf16_ops * k, self.nbytes * k)

    @property
    def least_s(self) -> float:
        """The least time the card could take: the larger of the operations
        over their peaks and the bytes over the HBM rate."""
        t_ops = self.int8_ops / PEAK_OPS["int8"] + self.bf16_ops / PEAK_OPS["bf16"]
        return max(t_ops, self.nbytes / HBM_BW)


def int8_linear(din: int, dout: int, rows: float) -> Work:
    """One W8A8 linear over ``rows`` rows: the int8 weight and its f32 scales
    read once, the rows' int8 codes and f32 scales read, bf16 out written."""
    return Work(int8_ops=2.0 * rows * din * dout,
                nbytes=din * dout + 4.0 * dout + rows * (din + 4.0 + 2.0 * dout))


def dense_gemm(d: Dims, rows: float, logits: bool) -> Work:
    """Every int8 linear over ``rows`` rows."""
    w = Work()
    for din, dout in d.dense_linears(logits):
        w = w + int8_linear(din, dout, rows)
    return w


def paged_attn(d: Dims, window: int, live: int, context: float) -> Work:
    """The cache read of one verify step: ``live`` rows of ``window`` queries,
    whose committed contexts sum to ``context`` keys (K and V read once,
    bf16), q read and the output written, every layer; 4·dh operations per
    query head and visible key."""
    return Work(bf16_ops=4.0 * d.num_heads * d.head_dim * window * context,
                nbytes=2.0 * context * d.kv_dim * 2.0
                + live * 2.0 * window * d.q_dim * 2.0).scaled(d.num_layers)


def other_weights_bytes(d: Dims, rows: float) -> float:
    """What a forward reads besides the int8 linears: the embedding's rows,
    the f32 norm scales and smoothing vectors."""
    D = d.d_model
    nbytes = rows * D * 2.0 + (2 * d.num_layers + 1) * D * 4.0
    return nbytes + sum(din for din, _ in d.dense_linears(True)) * 4.0


def verify_step(d: Dims, window: int, live: int, context: float) -> Work:
    """One decode/verify step of ``live`` rows whose contexts sum to
    ``context``: every weight read once, the window's tokens through every
    linear and the attention, the cache read up to each row's context and
    the window's K/V written."""
    rows = float(window * live)
    w = dense_gemm(d, rows, logits=True) + paged_attn(d, window, live, context)
    w.nbytes += other_weights_bytes(d, rows) + rows * d.kv_bytes_per_token()
    return w


def prefill(d: Dims, tokens: int) -> Work:
    """One request's prompt into the cache: ``tokens`` rows (the prompt less
    its last token) through every linear but ``lm_head``, causal attention
    over them, the cache rows written."""
    w = dense_gemm(d, tokens, logits=False)
    w.bf16_ops += 4.0 * d.num_heads * d.head_dim * tokens * (tokens + 1) / 2.0 * d.num_layers
    w.nbytes += other_weights_bytes(d, tokens) + tokens * d.kv_bytes_per_token()
    return w


def share(work: Work, seconds: float) -> Optional[float]:
    """The least time of ``work`` as a percentage of ``seconds``; None when
    nothing was counted or timed."""
    if seconds <= 0 or work.least_s <= 0:
        return None
    return 100.0 * work.least_s / seconds

