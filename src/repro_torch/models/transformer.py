"""Decoder stack — port of ``repro/models/transformer.py``: self-attention
+ FFN (or MoE FFN) blocks over a contiguous or paged KV cache, Mamba2
blocks over a recurrent SSM cache, zamba2's shared attention block,
llama-3.2-vision's gated cross-attention layers, whisper's decoder blocks
(self + cross + FFN) and its bidirectional encoder, with the pruned-stack
(``num_layers``) and token-tree verify windows, and both commits.

The parameter tree is an ``nn.Module`` tree whose submodule paths are the
reference pytree's paths (``embed/w``, ``layers/<i>/attn/q``,
``layers/<i>/ffn/up``, ``layers/<i>/moe/{router,up,gate,down,dense}``,
``layers/<i>/norm``, ``layers/<i>/ssm/{in_proj,out_proj,conv_w,…}``,
``layers/<i>/cross/{q,k,v,o}``, ``layers/<i>/{gate_attn,gate_ffn}``,
``layers/<i>/cross_norm``, ``shared_attn/{attn,ffn}/…``,
``encoder/layers/<i>/…``, ``encoder/norm``, ``final_norm``, ``lm_head``),
so calibration statistics, quantization and the weight bridge address
linears by the same names.

A ``cross`` layer's cache is ``{"ck","cv"}`` (filled at prefill from the
image embeddings, read at decode); an ``audio`` layer's is ``{"self":
<attention cache>, "ck", "cv"}``, the encoder output's K/V beside the
decoder's own.  Without ``aux_embeds`` the cross caches keep what they
hold (zeros in a fresh cache), as in the reference, whose serve CLI passes
none.

zamba2 (``hybrid``) applies one shared attention+FFN block (a single
parameter set) after every ``attn_every``-th SSM layer, each application
with its own KV cache in the cache's ``"shared"`` list.

Under ``sliding_window`` every self-attention cache (dense, MoE, whisper's
``"self"``, zamba2's ``"shared"``) is a ring (``models/attention.py``),
and every causal self-attention, the no-cache forward's included, sees at
most that many positions back.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.paged_cache import physical_slots
from repro_torch.models.attention import (NEG_POS, Attention, CrossAttention,
                                          init_attn_cache, init_cross_cache)
from repro_torch.models.common import Norm, embed_init, fixed_rows_matmul
from repro_torch.models.ffn import FFN, apply_linear
from repro_torch.models.linear import Linear
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM, commit_ssm_cache, init_ssm_cache


TIED_ROWS = 32     # rows per tied-logits GEMM on the card (one shape, one kernel)


def tied_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(…, D) × the tied embedding (V, D) → (…, V) f32 logits, the
    reference's ``x.f32 @ embed.f32.T``, taken in fixed chunks of TIED_ROWS
    rows on the card so that a row's logits do not depend on the window
    or batch it came in (vanilla's 4 rows against a verify window's 24).
    Training takes one product: row invariance is a serving property, and
    in a train step the chunks multiply the launches and the gradient
    sums of the largest product."""
    x32 = x.float().reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = x32 @ w.float().T
    else:
        out = fixed_rows_matmul(x32, w.float().T, TIED_ROWS)
    return out.reshape(*x.shape[:-1], w.shape[0])


def layer_kinds(cfg) -> List[str]:
    """Each layer's kind, as the reference derives it: ``dense``, ``moe``,
    ``ssm``, ``cross`` (every ``cross_attn_every``-th layer) or ``audio``."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.arch_type in ("ssm", "hybrid"):
            kinds.append("ssm")
        elif cfg.arch_type == "audio":
            kinds.append("audio")
        elif cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            kinds.append("cross")
        elif cfg.is_moe:
            kinds.append("moe")
        else:
            kinds.append("dense")
    return kinds


def shared_attn_positions(cfg) -> List[int]:
    """The layers after which zamba2's shared attention block applies."""
    if cfg.arch_type != "hybrid" or not cfg.attn_every:
        return []
    return [i for i in range(cfg.num_layers) if (i + 1) % cfg.attn_every == 0]


ATTN_IMPLS = ("auto", "jnp", "pallas")


def check_supported(cfg) -> None:
    if cfg.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        raise NotImplementedError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; expected one of {ATTN_IMPLS}")


def _call(blk: nn.Module, *args, **kw):
    return blk(*args, **kw)


def _remat_call(blk: nn.Module, *args, aux: Optional[list] = None, **kw):
    """``blk(*args, **kw)`` with its activations recomputed in the backward
    pass (``torch.utils.checkpoint``, non-reentrant): per layer, the remat
    policy of the reference's scanned layer body.  Training only (no
    cache).  The recomputation reads the block's tensors as they are when
    the backward runs, so a caller that swaps tensors into the model keeps
    them there until then (``train/trainer.value_and_grad`` takes the
    gradients inside its ``functional_call``).  An MoE block's aux losses
    come back as outputs, so a recomputation appends nothing to ``aux``."""
    def run(*a):
        local = [] if aux is not None else None
        out, cache = blk(*a, **kw, **({} if local is None else {"aux": local}))
        if cache is not None:
            raise ValueError("remat recomputes a layer: it takes no cache")
        return (out, *(local or ()))

    # the forward draws no random numbers: no RNG state to stash (a step
    # captured as a CUDA graph could not read it)
    out, *losses = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    if aux is not None:
        aux.extend(losses)
    return out, None


class Embed(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)


class Block(nn.Module):
    """Decoder block: x + attn(norm(x)), then + ffn(norm(x)) (a dense
    block) or + moe(norm(x)) (an MoE block: exactly one of ``ffn`` and
    ``moe`` is set).  Each norm is told which linears read it, so on the
    card it can quantize for them in the same launch
    (``models/common.Norm``); calibration (``collect``) needs the normed
    tensor and tells it none, and so does an MoE block's FFN norm, which
    the f32 router reads."""

    def __init__(self, attn_norm: Norm, attn: Attention, ffn_norm: Norm,
                 ffn: Optional[FFN] = None, moe: Optional[MoE] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block has either an FFN or an MoE FFN")
        self.attn_norm, self.attn, self.ffn_norm = attn_norm, attn, ffn_norm
        self.ffn, self.moe = ffn, moe

    @classmethod
    def init(cls, generator, cfg, device, kind: str = "dense"):
        attn_norm, attn = Norm(cfg, cfg.d_model, device), Attention.init(generator, cfg, device)
        ffn_norm = Norm(cfg, cfg.d_model, device)
        if kind == "moe":
            return cls(attn_norm, attn, ffn_norm, moe=MoE.init(generator, cfg, device))
        return cls(attn_norm, attn, ffn_norm, ffn=FFN.init(generator, cfg, device))

    def forward(self, x, qpos, cache=None, *, read_cache=True, collect=None, path="",
                tree=None, block_tables=None, plain_attn=False, aux=None, causal=True):
        calib = collect is not None
        h, cache = self.attn(self.attn_norm(x, () if calib else self.attn.readers()), qpos,
                             cache=cache, read_cache=read_cache, collect=collect,
                             path=f"{path}/attn", tree=tree, block_tables=block_tables,
                             plain_attn=plain_attn, causal=causal)
        x = x + h
        if self.moe is not None:
            return x + self.moe(self.ffn_norm(x), collect, f"{path}/moe", aux), cache
        x = x + self.ffn(self.ffn_norm(x, () if calib else self.ffn.readers()), collect,
                         f"{path}/ffn")
        return x, cache


def _gated(gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """tanh(gate) · h, the f32 scalar gate's tanh cast to h's dtype first, as
    the reference applies llama-3.2's gates."""
    return torch.tanh(gate).to(h.dtype) * h


class CrossBlock(nn.Module):
    """llama-3.2-vision's cross layer: x + tanh(gate_attn)·cross(norm(x)),
    then x + tanh(gate_ffn)·ffn(norm(x)).  The gates are f32 scalars,
    initialised to 0 as in the reference (so a fresh layer adds nothing).
    The attention norm's one reader is the cross q (k and v read the image
    embeddings)."""

    def __init__(self, attn_norm: Norm, cross: CrossAttention, ffn_norm: Norm, ffn: FFN,
                 gate_attn: torch.Tensor, gate_ffn: torch.Tensor):
        super().__init__()
        self.attn_norm, self.cross, self.ffn_norm, self.ffn = attn_norm, cross, ffn_norm, ffn
        self.register_buffer("gate_attn", gate_attn)
        self.register_buffer("gate_ffn", gate_ffn)

    @classmethod
    def init(cls, generator, cfg, device):
        zero = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
        return cls(Norm(cfg, cfg.d_model, device), CrossAttention.init(generator, cfg, device),
                   Norm(cfg, cfg.d_model, device), FFN.init(generator, cfg, device),
                   zero(), zero())

    def forward(self, x, cache=None, *, enc_out=None, collect=None, path=""):
        calib = collect is not None
        h, cache = self.cross(self.attn_norm(x, () if calib else self.cross.readers()),
                              kv_embeds=enc_out, cache=cache, collect=collect,
                              path=f"{path}/cross")
        x = x + _gated(self.gate_attn, h)
        h = self.ffn(self.ffn_norm(x, () if calib else self.ffn.readers()), collect,
                     f"{path}/ffn")
        return x + _gated(self.gate_ffn, h), cache


class AudioBlock(nn.Module):
    """whisper's decoder block: x + attn(norm(x)) over the decoder's own
    cache (``cache["self"]``), x + cross(norm(x)) over the encoder output
    (``cache["ck"]``/``["cv"]``), x + ffn(norm(x))."""

    def __init__(self, attn_norm: Norm, attn: Attention, cross_norm: Norm,
                 cross: CrossAttention, ffn_norm: Norm, ffn: FFN):
        super().__init__()
        self.attn_norm, self.attn, self.cross_norm = attn_norm, attn, cross_norm
        self.cross, self.ffn_norm, self.ffn = cross, ffn_norm, ffn

    @classmethod
    def init(cls, generator, cfg, device):
        return cls(Norm(cfg, cfg.d_model, device), Attention.init(generator, cfg, device),
                   Norm(cfg, cfg.d_model, device), CrossAttention.init(generator, cfg, device),
                   Norm(cfg, cfg.d_model, device), FFN.init(generator, cfg, device))

    def forward(self, x, qpos, cache=None, *, read_cache=True, enc_out=None, collect=None,
                path="", tree=None, plain_attn=False):
        calib = collect is not None
        h, _ = self.attn(self.attn_norm(x, () if calib else self.attn.readers()), qpos,
                         cache=cache["self"] if cache is not None else None,
                         read_cache=read_cache, collect=collect, path=f"{path}/attn",
                         tree=tree, plain_attn=plain_attn)
        x = x + h
        h, _ = self.cross(self.cross_norm(x, () if calib else self.cross.readers()),
                          kv_embeds=enc_out, cache=cache, collect=collect,
                          path=f"{path}/cross")
        x = x + h
        x = x + self.ffn(self.ffn_norm(x, () if calib else self.ffn.readers()), collect,
                         f"{path}/ffn")
        return x, cache


class Encoder(nn.Module):
    """whisper's bidirectional encoder: dense blocks with non-causal
    attention over the frame embeddings (no cache), then a final norm.  Run
    once, at prefill."""

    def __init__(self, cfg, layers, norm: Norm):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(layers)
        self.norm = norm

    @classmethod
    def init(cls, generator, cfg, device):
        return cls(cfg, [Block.init(generator, cfg, device) for _ in range(cfg.encoder_layers)],
                   Norm(cfg, cfg.d_model, device))

    def forward(self, embeds, collect=None, path: str = "encoder", remat: bool = False):
        B, S, _ = embeds.shape
        pos = torch.arange(S, dtype=torch.int32, device=embeds.device).expand(B, S)
        x = embeds.to(self.cfg.dtype)
        call = _remat_call if remat else _call
        for i, blk in enumerate(self.layers):
            x, _ = call(blk, x, pos, collect=collect, path=f"{path}/layers/{i}", causal=False)
        return self.norm(x)


class SSMBlock(nn.Module):
    """Mamba2 block: x + ssm(norm(x)).  On the card the pre-norm quantizes
    for ``in_proj`` in the same launch when it is W8A8/W4A8
    (``models/common.Norm``)."""

    def __init__(self, norm: Norm, ssm: SSM):
        super().__init__()
        self.norm, self.ssm = norm, ssm

    @classmethod
    def init(cls, generator, cfg, device):
        return cls(Norm(cfg, cfg.d_model, device), SSM.init(generator, cfg, device))

    def forward(self, x, cache=None, *, collect_states=False, collect=None, path=""):
        h, cache = self.ssm(self.norm(x, () if collect is not None else self.ssm.readers()),
                            cache, collect_states=collect_states, collect=collect,
                            path=f"{path}/ssm")
        return x + h, cache


_LAYER_INIT = {"ssm": SSMBlock.init, "cross": CrossBlock.init, "audio": AudioBlock.init}


class Transformer(nn.Module):
    """The parameter tree and the forward pass of one decoder (with
    whisper's encoder)."""

    def __init__(self, cfg, embed: Embed, layers, final_norm: Norm,
                 lm_head: Optional[nn.Module], shared_attn: Optional[Block] = None,
                 encoder: Optional[Encoder] = None):
        super().__init__()
        check_supported(cfg)
        if bool(shared_attn_positions(cfg)) != (shared_attn is not None):
            raise ValueError("a hybrid decoder has exactly one shared attention block")
        if bool(cfg.encoder_layers) != (encoder is not None):
            raise ValueError(f"{cfg.name} has {cfg.encoder_layers} encoder layers")
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.shared_attn = shared_attn
        self.encoder = encoder

    @classmethod
    def init(cls, cfg, generator: torch.Generator, device) -> "Transformer":
        """Seeded random weights with the reference's distributions."""
        check_supported(cfg)
        layers = [_LAYER_INIT[kind](generator, cfg, device) if kind in _LAYER_INIT
                  else Block.init(generator, cfg, device, kind) for kind in layer_kinds(cfg)]
        lm_head = (None if cfg.tie_embeddings else
                   Linear.init(generator, cfg.d_model, cfg.vocab_size, False, cfg.dtype, device))
        embed = Embed(embed_init(generator, (cfg.vocab_size, cfg.d_model), cfg.dtype, device))
        shared = (Block.init(generator, cfg, device, "dense") if shared_attn_positions(cfg)
                  else None)
        encoder = Encoder.init(generator, cfg, device) if cfg.encoder_layers else None
        return cls(cfg, embed, layers, Norm(cfg, cfg.d_model, device), lm_head, shared,
                   encoder)

    def forward(self, tokens, start, *, cache: Optional[dict] = None,
                read_cache: bool = True, collect=None, need_logits: bool = True,
                path: str = "", num_layers: Optional[int] = None,
                tree_depths=None, tree_mask=None, tree_bits=None,
                plain_attn: bool = False, aux: Optional[list] = None,
                collect_states: bool = False, aux_embeds=None, remat: bool = False):
        """tokens (B,T) int, start (B,) first position →
        (logits (B,T,V) f32 or None, cache or None).  ``aux_embeds`` (B, Sa,
        D): the image embeddings a cross layer reads, or the audio frames
        whisper's encoder turns into what its decoder blocks read; the cross
        layers write their K/V into the cache (prefill) and read them from
        there when none are given (decode).  ``aux``: a list each
        MoE layer appends its load-balance loss to (``Model.forward``); the
        decode and verify steps pass none and compute none.
        ``collect_states`` (the speculative verify window) makes each SSM
        layer's entry of the returned cache a candidate for
        :func:`commit_cache` (``models/ssm.py``); every other cache entry is
        written in place.

        ``num_layers`` runs the first layers only (the pruned drafter); the
        final norm and ``lm_head`` still apply.  ``tree_depths`` (T,) and
        ``tree_mask`` (T, T) bool make the window a packed token tree:
        positions follow node depth while cache slots follow packed order
        (``start + arange(T)``), and the ancestor mask replaces position
        causality inside the window; ``tree_bits`` is the mask as the bit
        words the attention kernel reads (``TreeTables.mask_bits``).

        A cache holding a block table ``"bt"`` is the paged serving cache
        (``core/paged_cache.py``): decode/verify only, since admission
        prefills a contiguous row and scatters it into blocks.
        ``plain_attn`` reads the cache through the plain attention path
        (``Model.prefill_chunk``).  ``remat`` (training, no cache)
        recomputes each layer's activations in the backward pass
        (:func:`_remat_call`)."""
        cfg = self.cfg
        block_tables = cache.get("bt") if cache is not None else None
        if block_tables is not None and not read_cache:
            raise NotImplementedError(
                "paged caches do not support forward-pass prefill; admission "
                "prefills a contiguous row and scatters it into the pool")
        T = tokens.shape[1]
        arange = torch.arange(T, dtype=torch.int32, device=tokens.device)
        tree = None
        if tree_depths is not None:
            qpos = (start[:, None] + tree_depths[None, :]).to(torch.int32)
            tree = dict(slots=(start[:, None] + arange).to(torch.int32),
                        mask=tree_mask, bits=tree_bits, win_start=start)
        else:
            qpos = (start[:, None] + arange).to(torch.int32)
        x = self.embed.w[tokens.long()].to(cfg.dtype)
        enc_out = None
        if aux_embeds is not None:
            enc_out = (self.encoder(aux_embeds, collect, f"{path}encoder", remat)
                       if self.encoder is not None else aux_embeds.to(cfg.dtype))
        shared_pos = shared_attn_positions(cfg)
        shared_caches = (cache.get("shared") or []) if cache is not None else []
        call = _remat_call if remat else _call
        new_layers, shared_i = [], 0
        for i, blk in enumerate(self.layers[:num_layers or cfg.num_layers]):
            lcache = cache["layers"][i] if cache is not None else None
            if isinstance(blk, SSMBlock):
                x, lcache = call(blk, x, lcache, collect_states=collect_states,
                                 collect=collect, path=f"{path}layers/{i}")
            elif isinstance(blk, CrossBlock):
                x, lcache = call(blk, x, lcache, enc_out=enc_out, collect=collect,
                                 path=f"{path}layers/{i}")
            elif isinstance(blk, AudioBlock):
                x, lcache = call(blk, x, qpos, lcache, read_cache=read_cache, enc_out=enc_out,
                                 collect=collect, path=f"{path}layers/{i}", tree=tree,
                                 plain_attn=plain_attn)
            else:
                x, lcache = call(blk, x, qpos, lcache, read_cache=read_cache, collect=collect,
                                 path=f"{path}layers/{i}", tree=tree,
                                 block_tables=block_tables, plain_attn=plain_attn, aux=aux)
            new_layers.append(lcache)
            if i in shared_pos:        # zamba2: the shared block, its own KV cache
                scache = shared_caches[shared_i] if shared_caches else None
                x, _ = call(self.shared_attn, x, qpos, scache, read_cache=read_cache,
                            collect=collect, path=f"{path}shared_attn",
                            plain_attn=plain_attn)
                shared_i += 1
        if cache is not None and any(a is not b for a, b in zip(new_layers, cache["layers"])):
            cache = {**cache, "layers": new_layers}     # SSM verify candidates
        logits = None
        if need_logits:
            if cfg.tie_embeddings:
                logits = tied_logits(self.final_norm(x), self.embed.w)
            else:
                x = self.final_norm(x, () if collect is not None else (self.lm_head,))
                logits = apply_linear(self.lm_head, x, collect, f"{path}lm_head").float()
        return logits, cache


def with_config(params: Transformer, cfg) -> Transformer:
    """A view of ``params`` under another configuration of the same shapes
    (e.g. a dropless MoE capacity factor): every tensor shared.  The
    reference passes the config beside its params; the port's modules hold
    it."""
    check_supported(cfg)
    out = copy.deepcopy(params, {id(t): t for t in params.buffers()})
    for mod in out.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = cfg
    return out


def param_leaves(mod: nn.Module, path: str = ""):
    """``(path, owner module, buffer name, tensor)`` of every buffer of a
    parameter tree in the reference pytree's flatten order: keys sorted at
    each level, layer lists by index.  The trainer differentiates the
    floating-point ones (``train/trainer.train_leaves``);
    ``serving/faults.poison_params`` overwrites the largest."""
    items = {name: t for name, t in mod.named_buffers(recurse=False)}
    items.update(mod.named_children())
    if isinstance(mod, nn.ModuleList):
        keys = sorted(items, key=int)
    else:
        keys = sorted(items)
    for k in keys:
        v = items[k]
        if isinstance(v, nn.Module):
            yield from param_leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", mod, k, v


def init_cache(cfg, batch: int, max_len: int, device,
               num_layers: Optional[int] = None) -> dict:
    """Allocate the serving cache (of the first ``num_layers`` layers): an
    attention cache, an SSM cache, a cross layer's ``{"ck","cv"}`` or an
    audio layer's ``{"self", "ck", "cv"}`` per layer, and for a hybrid
    decoder one attention cache per shared-block application among them
    (``"shared"``).  ``max_len`` is rounded up so the chunked attention path
    (multiples of 1024) always applies to big buffers; under a
    ``sliding_window`` each attention cache is then a ring of
    ``min(window, max_len) + RING_PAD`` slots."""
    check_supported(cfg)
    max_len = -(-max_len // 1024) * 1024 if max_len > 4096 else -(-max_len // 128) * 128
    kinds = layer_kinds(cfg)[:num_layers or cfg.num_layers]
    w = cfg.sliding_window

    def layer(kind):
        if kind == "ssm":
            return init_ssm_cache(cfg, batch, device)
        if kind == "cross":
            return init_cross_cache(cfg, batch, cfg.num_image_tokens, device)
        if kind == "audio":
            return {"self": init_attn_cache(cfg, batch, max_len, device, w),
                    **init_cross_cache(cfg, batch, cfg.num_audio_frames, device)}
        return init_attn_cache(cfg, batch, max_len, device, w)

    cache = {"layers": [layer(kind) for kind in kinds]}
    shared = [i for i in shared_attn_positions(cfg) if num_layers is None or i < num_layers]
    if shared:
        cache["shared"] = [init_attn_cache(cfg, batch, max_len, device, w) for _ in shared]
    return cache


def reset_cache(tree: dict) -> None:
    """Empty a cache (or rows of it, :func:`cache_rows`) in place, as a
    fresh :func:`init_cache` holds it: every buffer zero, a ring's ``kpos``
    at ``NEG_POS``."""
    for name, t in tree.items():
        if isinstance(t, dict):
            reset_cache(t)
        elif isinstance(t, list):
            for layer in t:
                reset_cache(layer)
        elif name == "kpos":
            t.fill_(NEG_POS)
        else:
            t.zero_()


def self_kv(layer: dict) -> Optional[dict]:
    """The self-attention K/V a verify window writes in a layer's cache: the
    layer's own dict, an audio layer's ``"self"``, or None for a cross
    layer (its ``ck``/``cv`` are written at prefill only)."""
    if "self" in layer:
        return layer["self"]
    return None if "ck" in layer else layer


def cache_rows(cache: dict, row: int) -> dict:
    """Views of batch row ``row`` of every tensor of a contiguous cache
    (``"layers"`` and ``"shared"``, an audio layer's ``"self"`` too): writes
    through them land in the cache."""
    def view(layer):
        return {name: view(t) if isinstance(t, dict) else t[row:row + 1]
                for name, t in layer.items()}

    out = {"layers": [view(layer) for layer in cache["layers"]]}
    if "shared" in cache:
        out["shared"] = [view(layer) for layer in cache["shared"]]
    return out


def commit_cache(cfg, cache: dict, n_last) -> dict:
    """Resolve verify-candidate caches after acceptance.  Attention caches
    need no work: slot positions and masking handle rollback.  SSM
    candidates are gathered to the accepted token's state, in place
    (:func:`~repro_torch.models.ssm.commit_ssm_cache`), and the returned
    cache holds the same tensors, in the same order, as before the step."""
    if not any("states_all" in layer for layer in cache["layers"]):
        return cache
    layers = [commit_ssm_cache(layer, n_last) if "states_all" in layer else layer
              for layer in cache["layers"]]
    return {**cache, "layers": layers}


def _compact_attn_rows(lcache: dict, start, path_nodes, n_accept) -> dict:
    """Move the accepted tree path's K/V rows into chain slots, in place.

    A tree window wrote node ``i`` at slot ``start + i`` with RoPE position
    ``start + depth[i]``; an accepted node at depth ``d`` has position
    ``start + d``, its committed slot, so committing is a pure row move
    ``start + path_nodes[d] → start + d`` for ``d ≤ n_accept``.  Both
    sides are gathered before the scatter (``src`` and ``dst`` overlap
    for chains, whose rows move onto themselves)."""
    B, D1 = path_nodes.shape
    D = D1 - 1
    if D == 0:
        return lcache
    S = lcache["k"].shape[1]
    depth = torch.arange(1, D + 1, dtype=torch.int64, device=start.device)[None, :]
    src = (start[:, None].long() + path_nodes[:, 1:].long()).clamp(0, S - 1)   # (B, D)
    dst = (start[:, None].long() + depth).clamp(0, S - 1)
    keep = depth <= n_accept[:, None]                                          # (B, D)
    bidx = torch.arange(B, device=start.device)[:, None]
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in lcache:
            continue
        buf = lcache[name]
        moved, stay = buf[bidx, src], buf[bidx, dst]
        tail = (1,) * (buf.dim() - 2)
        buf[bidx, dst] = torch.where(keep.reshape(keep.shape + tail), moved, stay)
    return lcache


def _compact_attn_rows_paged(lcache: dict, bt, start, path_nodes, n_accept) -> dict:
    """Paged-layout tree commit, in place: the row moves of
    :func:`_compact_attn_rows` with logical slots translated to pool rows
    through the block table.  Live rows move rows only inside their own
    blocks (``start + node <= start + gamma`` is within the request's
    allocation); idle rows compact inside the scratch block, whose content
    is never validly read."""
    B, D1 = path_nodes.shape
    D = D1 - 1
    if D == 0:
        return lcache
    block_size = lcache["k"].shape[1]
    S = bt.shape[1] * block_size
    depth = torch.arange(1, D + 1, dtype=torch.int64, device=start.device)[None, :]
    src = (start[:, None].long() + path_nodes[:, 1:].long()).clamp(0, S - 1)   # (B, D)
    dst = (start[:, None].long() + depth).clamp(0, S - 1)
    keep = depth <= n_accept[:, None]                                          # (B, D)
    phys_src = physical_slots(bt, src, block_size)
    phys_dst = physical_slots(bt, dst, block_size)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in lcache:
            continue
        flat = lcache[name].view((-1,) + tuple(lcache[name].shape[2:]))
        moved, stay = flat[phys_src], flat[phys_dst]                           # (B, D, ...)
        tail = (1,) * (moved.dim() - 2)
        vals = torch.where(keep.reshape(keep.shape + tail), moved, stay)
        flat[phys_dst.reshape(-1)] = vals.reshape((-1,) + tuple(vals.shape[2:]))
    return lcache


def commit_cache_tree(cfg, cache: dict, start, path_nodes, n_accept) -> dict:
    """Resolve tree-verify candidate caches: compact the accepted
    root-to-leaf path of every layer's self-attention K/V (see
    :func:`_compact_attn_rows`; :func:`_compact_attn_rows_paged` for a
    paged cache); cross caches stay as they are.  Attention-family layers
    only: recurrent and shared caches are refused, as
    ``core/spec_engine.make_decode_step`` refuses their models."""
    if any("state" in layer for layer in cache["layers"]):
        raise NotImplementedError("tree speculation does not support recurrent caches")
    if "shared" in cache:
        raise NotImplementedError(
            "tree speculation does not support shared-attention caches")
    bt = cache.get("bt")
    for lcache in cache["layers"]:
        kv = self_kv(lcache)
        if kv is None:
            continue
        if bt is not None:
            _compact_attn_rows_paged(kv, bt, start, path_nodes, n_accept)
        else:
            _compact_attn_rows(kv, start, path_nodes, n_accept)
    return cache
