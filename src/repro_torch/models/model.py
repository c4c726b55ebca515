"""Model facade: the public API the engine, the trainer and the launchers
use — port of ``repro/models/model.py``.

The port runs the canonical per-layer layout.  The reference's stacked
"scan" layout (``models/scan.py``) exists to shrink XLA programs; the
port's counterpart of its compiled scan is the CUDA graph of the decode
step, and of its per-layer remat the ``remat`` option here.  The layout
still crosses: :meth:`Model.to_scan` stacks a tree as the reference does,
:meth:`Model.params_from_tree` reads a reference tree in either layout, and
a cache with a ``"scan"`` entry is taken apart into per-layer views of its
stacked tensors, so the serving calls write into them in place."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device
from repro_torch.models import scan as S
from repro_torch.models import transformer
from repro_torch.models.transformer import Transformer


def init_params(cfg, generator: torch.Generator, device="cuda") -> Transformer:
    """Seeded random weights with the reference's distributions
    (``models/common.py`` initializers); the generator must live on
    ``device``."""
    return Transformer.init(cfg, generator, resolve_device(device))


def forward(params: Transformer, tokens, *, aux_embeds=None, collect=None, num_layers=None,
            remat=False):
    """Returns (logits (B,T,V) f32, aux loss) over positions 0..T-1: the
    MoE layers' load-balance losses summed in layer order (0 for a dense
    stack), as the reference's forward returns them.  ``aux_embeds`` (B,
    Sa, D): the image or audio embeddings a cross-attention model reads (it
    needs them here: there is no cache to read instead).  ``remat``
    recomputes each layer's activations in the backward pass (training;
    the reference's scan-layout option).  A calibration pass (``collect``)
    runs under ``torch.no_grad``: it records statistics and trains
    nothing."""
    start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    aux = []
    with torch.no_grad() if collect is not None else contextlib.nullcontext():
        logits, _ = params(tokens, start, collect=collect, num_layers=num_layers, aux=aux,
                           aux_embeds=aux_embeds, remat=remat)
    total = torch.zeros((), device=tokens.device)
    for a in aux:
        total = total + a
    return logits, total


class Model:
    """Thin facade over the decoder stack for one ModelConfig on one device."""

    def __init__(self, cfg, device="cuda"):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.attn_impl == "pallas" and self.device.type not in ("cuda", "meta"):
            raise ValueError("attn_impl 'pallas' runs the hand-written flash_decode kernels, "
                             "which need a CUDA card; on the CPU take 'auto' or 'jnp'")

    def init_params(self, generator: torch.Generator) -> Transformer:
        return init_params(self.cfg, generator, self.device)

    def init_cache(self, batch: int, max_len: int, num_layers=None, scan: bool = False) -> dict:
        cache = transformer.init_cache(self.cfg, batch, max_len, self.device, num_layers)
        return S.stack_cache(cache, self.cfg) if scan else cache

    def to_scan(self, params_or_cache) -> dict:
        """The reference's scan layout of a parameter tree (a
        ``Transformer`` or a reference-layout dict) or of a cache, as the
        reference's ``Model.to_scan`` picks: a tree with ``"layers"`` is
        stacked as params."""
        if isinstance(params_or_cache, Transformer):
            from repro_torch.bridge import to_tree

            params_or_cache = to_tree(params_or_cache)
        if "layers" in params_or_cache:
            return S.stack_params(params_or_cache, self.cfg)
        return S.stack_cache(params_or_cache, self.cfg)

    def params_from_tree(self, tree: dict) -> Transformer:
        """A reference parameter tree (numpy leaves, as a checkpoint loads;
        per-layer or scan layout) → this model's parameters on its device."""
        from repro_torch.bridge import from_jax_params

        return from_jax_params(tree, self.cfg, device=self.device)

    def _layers(self, cache):
        return S.unstack_cache(cache, self.cfg) if cache is not None and "scan" in cache \
            else cache

    # -- full forward (train / calibration / fidelity eval) -----------------
    def forward(self, params: Transformer, tokens, *, aux_embeds=None, collect=None,
                num_layers=None, remat=False):
        """:func:`forward` of this model."""
        return forward(params, tokens, aux_embeds=aux_embeds, collect=collect,
                       num_layers=num_layers, remat=remat)

    # -- serving ------------------------------------------------------------
    def prefill(self, params: Transformer, cache: dict, tokens, num_layers=None, *,
                aux_embeds=None) -> dict:
        """Process the prompt *except its last token* into the cache (the
        caller passes ``prompts[:, :-1]``); the last prompt token becomes
        the first token of the first verify window.  ``aux_embeds`` (B, Sa,
        D) fill the cross layers' ``ck``/``cv`` (whisper: through the
        encoder); without them those keep what they hold."""
        start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        _, cache = params(tokens, start, cache=self._layers(cache), read_cache=False,
                          need_logits=False, num_layers=num_layers, aux_embeds=aux_embeds)
        return cache

    def prefill_chunk(self, params: Transformer, cache: dict, tokens, start: int,
                      num_layers=None) -> dict:
        """Prefill a prompt *tail* against an already-warm contiguous cache,
        in place: rows ``[0, start)`` of ``cache`` hold earlier context (a
        shared prompt prefix gathered from the paged prefix cache) and
        ``tokens`` (B, T) continue it at absolute position ``start``.  The
        chunk attends through the plain path, as the reference forces
        ``jnp`` there, so it attends over the cached prefix as a
        full-prompt prefill does over its own rows."""
        st = torch.full((tokens.shape[0],), int(start), dtype=torch.int32,
                        device=tokens.device)
        _, cache = params(tokens, st, cache=self._layers(cache), read_cache=True,
                          need_logits=False, num_layers=num_layers, plain_attn=True)
        return cache

    def verify_step(self, params: Transformer, cache: dict, window_tokens, start,
                    num_layers=None, tree_depths=None, tree_mask=None, tree_bits=None):
        """Forward a speculative window (B, T=γ+1) at per-row ``start``.

        ``tree_depths`` / ``tree_mask`` (and the mask's bit words
        ``tree_bits``) make the window a packed token tree
        (``core/tree.TreeTemplate``): node positions follow depth, cache
        slots follow packed order.  Returns (logits, candidate cache);
        resolve with :meth:`commit` (chain) or :meth:`commit_tree`.  SSM
        layers keep every window position's state for the commit
        (``collect_states``)."""
        return params(window_tokens, start, cache=self._layers(cache), num_layers=num_layers,
                      tree_depths=tree_depths, tree_mask=tree_mask, tree_bits=tree_bits,
                      collect_states=True)

    def decode_step(self, params: Transformer, cache: dict, token, start,
                    num_layers=None):
        """Vanilla single-token decode: (B,1) → (logits (B,1,V), cache)."""
        return params(token, start, cache=self._layers(cache), num_layers=num_layers)

    def commit(self, cache: dict, n_last) -> dict:
        """Chain commit: SSM layers keep the state after window token
        ``n_last`` (``transformer.commit_cache``)."""
        return transformer.commit_cache(self.cfg, cache, n_last)

    def commit_tree(self, cache: dict, start, path_nodes, n_accept) -> dict:
        """Tree-verify commit: move the accepted root-to-leaf path's K/V
        rows into chain slots (``transformer.commit_cache_tree``)."""
        return transformer.commit_cache_tree(self.cfg, cache, start, path_nodes,
                                             n_accept)
