"""Roofline terms at one NVIDIA H100's peaks — port of
``repro/launch/roofline.py``.

    compute term    = flops       / (cards × peak op rate of their type)
    memory term     = bytes       / (cards × HBM rate)
    collective term = coll_bytes  / NVLink rate          (per card)

The reference reads flops and bytes from XLA's cost analysis of a lowered
program and parses collectives out of its HLO text (``collective_bytes``).
PyTorch lowers nothing ahead of time, so here both come from a count over
shapes (:func:`step_counts`, :func:`prefill_counts`, :func:`train_counts`),
and the collective bytes are those the sharding plan implies
(``launch/sharding.py``): one all-reduce of each row-parallel linear's
output per forward when the ``"model"`` axis spans more than one card, none
on one card.  Every byte is counted once, as the least the card must move:

* a decode/verify step reads every weight of the prepared params once
  (int8/int4 codes, scales, smoothing vectors, bf16 norms and linears;
  of the embedding table only the window's rows, unless the table is also
  the tied ``lm_head``; of an MoE layer's experts at most as many as the
  window's slots can reach), reads the KV cache up to the committed
  context (:func:`kv_cache_read_bytes`; under a sliding window at most the
  ring's ``window + RING_PAD`` slots, :func:`kv_slots`), the cross caches
  and the SSM states, and writes the window's K/V (and each window
  position's SSM state, which the rollback commit keeps);
* its operations are 2 × active params × B·(γ+1) (:func:`model_flops_decode`)
  — in int8 for the quantized linears, bf16 for the rest — plus the
  attention's 4·Hq·dh per query token and key read, in bf16.

Hardware model (NVIDIA H100 SXM data sheet, dense rates at the 700 W
limit): 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s HBM, 80 GB.  ``chip_smoke.py`` takes its peaks and
its kernels' ``bound_ms`` from here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}   # f32: outside the tensor cores
PEAK_FLOPS_BF16 = PEAK_OPS["bf16"]
PEAK_FLOPS_INT8 = PEAK_OPS["int8"]
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # device memory of one card
# NVLink 4 of the H100 SXM: 900 GB/s per card in both directions together
# (18 links; NVIDIA H100 data sheet), so 450 GB/s each way.
NVLINK_BW = 450e9


def bound_ms(nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``ops`` operations of type ``kind`` (bf16, int8 or f32), and which of
    the two sets it: ``"bytes"`` or ``"operations"``."""
    t_bytes = nbytes / HBM_BW
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_layer_count(cfg) -> int:
    """Decoder layers that read a self-attention KV cache at decode time
    (hybrid archs count their shared-attention applications via the
    census; recurrent-only layers hold no KV rows)."""
    n_self, _, _, _, _ = cfg._layer_census()
    return n_self


def kv_bytes_per_token(cfg, kv_cache_dtype: str = None) -> float:
    """HBM bytes one committed token's K+V rows occupy in **one** layer
    (int8 halves the payload and adds the per-(token, head) f32 scales)."""
    dt = kv_cache_dtype or getattr(cfg, "kv_cache_dtype", "bf16")
    if dt not in ("bf16", "int8"):
        raise ValueError(f"unmodeled kv cache dtype {dt!r}")
    elem = 1.0 if dt == "int8" else 2.0
    per_token = 2.0 * cfg.kv_dim * elem             # K + V rows, one layer
    if dt == "int8":
        per_token += 2.0 * cfg.num_kv_heads * 4.0   # k_scale + v_scale f32
    return per_token


def kv_slots(cfg, context: int) -> int:
    """Cache slots a decode/verify step reads at ``context`` committed
    tokens: all of them, or under a sliding window at most the ring's
    ``window + RING_PAD`` (the ring kernel reads every slot of a wrapped
    ring, masked or not)."""
    if not cfg.sliding_window:
        return context
    from repro_torch.models.attention import RING_PAD

    return min(context, cfg.sliding_window + RING_PAD)


def kv_cache_read_bytes(cfg, batch: int, context: int, kv_cache_dtype: str = None) -> float:
    """HBM bytes to stream the KV cache once for a decode/verify step at
    ``context`` committed tokens (:func:`kv_slots` of them)."""
    per_token = kv_bytes_per_token(cfg, kv_cache_dtype)
    return float(batch) * float(kv_slots(cfg, context)) * attn_layer_count(cfg) * per_token


def kv_cache_capacity_bytes(cfg, request_tokens, max_len: int, kv_cache_dtype: str = None,
                            layout: str = "contiguous", block_size: int = None,
                            shared_prefix_tokens: int = 0) -> float:
    """HBM *footprint* of the serving group's KV cache: ``contiguous``
    charges every slot ``max_len`` rows (under a sliding window the ring's
    ``min(window, max_len) + RING_PAD``); ``paged`` (which refuses a window)
    charges each request its own demand rounded up to ``block_size``, one
    scratch block and the int32 block tables, and stores a shared prompt
    prefix's full blocks once (``core/paged_cache.PrefixIndex``)."""
    from repro_torch.core.paged_cache import DEFAULT_BLOCK_SIZE, blocks_for_tokens

    per_token = kv_bytes_per_token(cfg, kv_cache_dtype)
    layers = attn_layer_count(cfg)
    n = len(request_tokens)
    if layout == "contiguous":
        if cfg.sliding_window:
            from repro_torch.models.attention import RING_PAD

            max_len = min(cfg.sliding_window, max_len) + RING_PAD
        return float(n) * float(max_len) * layers * per_token
    if cfg.sliding_window:
        raise ValueError("kv_layout='paged' does not compose with sliding-window (ring) caches")
    if layout != "paged":
        raise ValueError(f"unknown kv layout {layout!r}")
    bs = DEFAULT_BLOCK_SIZE if block_size is None else block_size
    shared_full = max(int(shared_prefix_tokens), 0) // bs
    blocks = shared_full + sum(
        blocks_for_tokens(t - shared_full * bs, bs) for t in request_tokens) + 1
    table = n * blocks_for_tokens(max_len, bs) * 4.0     # int32 entries
    return float(blocks) * bs * layers * per_token + table


def model_flops_train(cfg, tokens: int) -> float:
    return 6.0 * cfg.active_param_count() * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_param_count() * tokens


@dataclasses.dataclass
class Roofline:
    flops: float                 # every operation, counted over shapes
    bytes_accessed: float        # every byte moved, each once
    coll_bytes: float            # per-card collective payload bytes
    coll_breakdown: Dict[str, float]
    chips: int
    model_flops: float = 0.0     # analytic 6·N·D (train) or 2·N·D (forward)
    kv_bytes: float = 0.0        # KV-cache read bytes (0 for train/prefill)
    int8_flops: float = 0.0      # the part of ``flops`` that runs in int8

    @property
    def t_compute(self) -> float:
        return ((self.flops - self.int8_flops) / PEAK_FLOPS_BF16
                + self.int8_flops / PEAK_FLOPS_INT8) / self.chips

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def t_kv_memory(self) -> float:
        """KV-cache share of the memory term — the piece int8 KV halves."""
        return self.kv_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """model_flops / flops: what remat and attention add."""
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> dict:
        """The reference's keys (``hlo_*`` hold the shape counts here)."""
        out = {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "hlo_gflops": self.flops / 1e9,
            "hlo_gbytes": self.bytes_accessed / 1e9,
            "coll_gbytes_per_chip": self.coll_bytes / 1e9,
            "useful_flops_ratio": self.useful_flops_ratio,
        }
        if self.kv_bytes:
            out["kv_gbytes"] = self.kv_bytes / 1e9
            out["t_kv_memory_s"] = self.t_kv_memory
            out["kv_share_of_memory"] = (self.kv_bytes / self.bytes_accessed
                                         if self.bytes_accessed else 0.0)
        return out


# ---------------------------------------------------------------------------
# Counts over shapes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def meta_params(cfg, verifier: str = "bf16"):
    """The port's parameter tree for ``cfg`` on the meta device (shapes and
    dtypes, nothing allocated), prepared for ``verifier``: a prepared tree
    shares its unquantized tensors with the ``"bf16"`` one, as the
    engine's does with the raw params."""
    import torch

    from repro_torch.core.protocols import get_verifier
    from repro_torch.models.model import Model

    model = Model(cfg, device="meta")
    if verifier == "bf16":
        return model.init_params(torch.Generator())
    return get_verifier(verifier).prepare(model, meta_params(cfg, "bf16"))


def _leaves(params):
    from repro_torch.models.transformer import param_leaves

    return [(path, t) for path, _, _, t in param_leaves(params)]


@dataclasses.dataclass
class _Weights:
    read: float            # bytes one forward reads
    int8_params: float     # quantized weights per token (active)
    row_out: int           # Σ dout of the row-parallel linears per token


def _weights(cfg, params, tokens: int, decode: bool) -> _Weights:
    """What one forward of ``tokens`` tokens reads of ``params``; a
    ``decode`` step skips the encoder and the cross layers' k/v linears
    (their output is cached at prefill)."""
    from repro_torch.launch.sharding import _ROW
    from repro_torch.models.transformer import shared_attn_positions

    E, k = cfg.num_experts, cfg.experts_per_token
    reach = min(1.0, tokens * k / E) if E else 1.0      # experts the slots can reach
    apps = len(shared_attn_positions(cfg))
    read = int8 = 0.0
    row_out = 0
    for path, t in _leaves(params):
        if decode and (path.startswith("encoder/") or "cross/k/" in path
                       or "cross/v/" in path):
            continue
        nbytes = t.numel() * t.element_size()
        expert = E and t.dim() == 3 and "moe/" in path
        if path == "embed/w" and not cfg.tie_embeddings:
            nbytes = min(tokens, t.shape[0]) * t.shape[1] * t.element_size()
        elif expert or (E and t.dim() == 2 and "moe/" in path and "w_scale" in path):
            nbytes *= reach
        read += nbytes
        name = path.rsplit("/", 1)[-1]
        if name in ("w_int8", "w_int4"):
            n = t.numel() * (2 if name == "w_int4" else 1)
            int8 += n * (k / E if expert else 1.0)
        if name in ("w", "w_int8", "w_int4") and t.dim() == 2 and \
                any(r in path + "/" for r in _ROW) and "moe/" not in path:
            dout = t.shape[0] if name != "w" else t.shape[1]
            row_out += dout * (apps if path.startswith("shared_attn/") else 1)
    return _Weights(read, int8, row_out)


def _attn_flops(cfg, query_tokens: float, context: float) -> float:
    """4·Hq·dh per query token and visible key, over the attention layers
    (cross layers over their Sa keys)."""
    n_self, n_cross, _, _, _ = cfg._layer_census()
    sa = cfg.num_image_tokens or cfg.num_audio_frames
    n_cross += cfg.num_layers if cfg.arch_type == "audio" else 0
    return 4.0 * cfg.num_heads * cfg.head_dim * query_tokens * (n_self * context + n_cross * sa)


def _recurrent_bytes(cfg, batch: int, window: int) -> float:
    """SSM layers: the state and conv tail read once; each window
    position's state written (the verify candidate the commit picks from)."""
    _, _, n_ssm, _, _ = cfg._layer_census()
    if not n_ssm:
        return 0.0
    state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4.0
    conv = 3 * (cfg.d_inner + 2 * cfg.ssm_state) * 2.0
    return n_ssm * batch * (state + conv + window * state)


def _cross_bytes(cfg, batch: int) -> float:
    """The cross layers' ``ck``/``cv`` read once (model dtype)."""
    _, n_cross, _, _, _ = cfg._layer_census()
    n_cross += cfg.num_layers if cfg.arch_type == "audio" else 0
    sa = cfg.num_image_tokens or cfg.num_audio_frames
    return n_cross * batch * sa * 2.0 * cfg.kv_dim * 2.0


def _all_reduce(row_out: int, tokens: int, cards: int, passes: int = 1) -> Dict[str, float]:
    """Per-card bytes of one ring all-reduce (2·(N-1)/N of the payload) of
    each row-parallel output, bf16, ``passes`` times."""
    if cards <= 1:
        return {"all-reduce": 0.0}
    return {"all-reduce": passes * 2.0 * (cards - 1) / cards * row_out * tokens * 2.0}


def step_counts(cfg, verifier: str, kv_cache_dtype: str, batch: int, context: int,
                window: int, cards: int = 1) -> Roofline:
    """The roofline of one decode/verify step: ``batch`` rows, a window of
    ``window`` tokens (γ + 1) at ``context`` committed tokens."""
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    tokens = batch * window
    w = _weights(cfg, meta_params(cfg, verifier), tokens, decode=True)
    kv = kv_cache_read_bytes(cfg, batch, context)
    write = tokens * attn_layer_count(cfg) * kv_bytes_per_token(cfg)
    nbytes = (w.read + kv + write + _cross_bytes(cfg, batch)
              + _recurrent_bytes(cfg, batch, window))
    mflops = model_flops_decode(cfg, tokens)
    coll = _all_reduce(w.row_out, tokens, cards)
    return Roofline(flops=mflops + _attn_flops(cfg, tokens, kv_slots(cfg, context)),
                    bytes_accessed=nbytes,
                    coll_bytes=sum(coll.values()), coll_breakdown=coll, chips=cards,
                    model_flops=mflops, kv_bytes=kv, int8_flops=2.0 * w.int8_params * tokens)


def prefill_counts(cfg, verifier: str, batch: int, seq: int, cards: int = 1) -> Roofline:
    """The prompt into the cache: weights once (embedding rows), causal
    attention over the prompt, the cache rows written."""
    tokens = batch * seq
    w = _weights(cfg, meta_params(cfg, verifier), tokens, decode=False)
    write = tokens * attn_layer_count(cfg) * kv_bytes_per_token(cfg)
    nbytes = w.read + write + _cross_bytes(cfg, batch) + _recurrent_bytes(cfg, batch, 0)
    mflops = model_flops_decode(cfg, tokens)
    coll = _all_reduce(w.row_out, tokens, cards)
    return Roofline(flops=mflops + _attn_flops(cfg, tokens, seq / 2), bytes_accessed=nbytes,
                    coll_bytes=sum(coll.values()), coll_breakdown=coll, chips=cards,
                    model_flops=mflops, int8_flops=2.0 * w.int8_params * tokens)


def train_counts(cfg, batch: int, seq: int, cards: int = 1) -> Roofline:
    """One AdamW step with per-layer remat: the forward twice and the
    backward (2×) — 8·N·D and the attention four times; the bf16 weights
    read three times, their gradients written and read, AdamW reading p,
    g, μ, ν and writing p, μ, ν (f32 moments), and each layer's input (B·T·D,
    what remat keeps) written once and read once; three all-reduces of each
    row-parallel output (forward, remat, backward)."""
    tokens = batch * seq
    params = meta_params(cfg, "bf16")
    p_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    n_float = sum(t.numel() for _, t in _leaves(params) if t.is_floating_point())
    act = 2.0 * cfg.num_layers * tokens * cfg.d_model * 2.0
    forward, grads = 3 * p_bytes, p_bytes
    adamw = (2 * p_bytes + 8.0 * n_float) + (p_bytes + 8.0 * n_float)   # reads, writes
    nbytes = forward + grads + adamw + act
    mflops = model_flops_train(cfg, tokens)
    w = _weights(cfg, params, tokens, decode=False)
    coll = _all_reduce(w.row_out, tokens, cards, passes=3)
    return Roofline(flops=4.0 / 3.0 * mflops + 4 * _attn_flops(cfg, tokens, seq / 2),
                    bytes_accessed=nbytes, coll_bytes=sum(coll.values()),
                    coll_breakdown=coll, chips=cards, model_flops=mflops)


def step_bound_ms(cfg, verifier: str, kv_cache_dtype: str, batch: int, context: int,
                  window: int) -> Tuple[float, str]:
    """The least time (ms) one card could take for one decode/verify step
    (:func:`step_counts`), and which of ``"bytes"`` and ``"operations"``
    sets it."""
    rf = step_counts(cfg, verifier, kv_cache_dtype, batch, context, window)
    t_ops = rf.t_compute
    t_bytes = rf.t_memory
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
