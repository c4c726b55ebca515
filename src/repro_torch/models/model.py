"""Model facade: the public API the engine and the launcher use — port of
``repro/models/model.py`` (canonical per-layer layout; the reference's
stacked "scan" layout exists to shrink XLA programs and has no eager
counterpart)."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import Transformer


def init_params(cfg, generator: torch.Generator, device="cuda") -> Transformer:
    """Seeded random weights with the reference's distributions
    (``models/common.py`` initializers); the generator must live on
    ``device``."""
    return Transformer.init(cfg, generator, resolve_device(device))


class Model:
    """Thin facade over the decoder stack for one ModelConfig on one device."""

    def __init__(self, cfg, device="cuda"):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, generator: torch.Generator) -> Transformer:
        return init_params(self.cfg, generator, self.device)

    def init_cache(self, batch: int, max_len: int, num_layers=None) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, self.device, num_layers)

    # -- full forward (calibration / fidelity eval) -----------------------
    def forward(self, params: Transformer, tokens, *, collect=None, num_layers=None):
        """Returns (logits (B,T,V) f32, aux loss) over positions 0..T-1: the
        MoE layers' load-balance losses summed in layer order (0 for a dense
        stack), as the reference's forward returns them."""
        start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        aux = []
        logits, _ = params(tokens, start, collect=collect, num_layers=num_layers, aux=aux)
        total = torch.zeros((), device=tokens.device)
        for a in aux:
            total = total + a
        return logits, total

    # -- serving ------------------------------------------------------------
    def prefill(self, params: Transformer, cache: dict, tokens, num_layers=None) -> dict:
        """Process the prompt *except its last token* into the cache (the
        caller passes ``prompts[:, :-1]``); the last prompt token becomes
        the first token of the first verify window."""
        start = torch.zeros(tokens.shape[0], dtype=torch.int32, device=tokens.device)
        _, cache = params(tokens, start, cache=cache, read_cache=False,
                          need_logits=False, num_layers=num_layers)
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
        _, cache = params(tokens, st, cache=cache, read_cache=True, need_logits=False,
                          num_layers=num_layers, plain_attn=True)
        return cache

    def verify_step(self, params: Transformer, cache: dict, window_tokens, start,
                    num_layers=None, tree_depths=None, tree_mask=None, tree_bits=None):
        """Forward a speculative window (B, T=γ+1) at per-row ``start``.

        ``tree_depths`` / ``tree_mask`` (and the mask's bit words
        ``tree_bits``) make the window a packed token tree
        (``core/tree.TreeTemplate``): node positions follow depth, cache
        slots follow packed order.  Returns (logits, candidate cache);
        resolve with :meth:`commit` (chain) or :meth:`commit_tree`."""
        return params(window_tokens, start, cache=cache, num_layers=num_layers,
                      tree_depths=tree_depths, tree_mask=tree_mask, tree_bits=tree_bits)

    def decode_step(self, params: Transformer, cache: dict, token, start,
                    num_layers=None):
        """Vanilla single-token decode: (B,1) → (logits (B,1,V), cache)."""
        return params(token, start, cache=cache, num_layers=num_layers)

    def commit(self, cache: dict, n_last) -> dict:
        return transformer.commit_cache(self.cfg, cache, n_last)

    def commit_tree(self, cache: dict, start, path_nodes, n_accept) -> dict:
        """Tree-verify commit: move the accepted root-to-leaf path's K/V
        rows into chain slots (``transformer.commit_cache_tree``)."""
        return transformer.commit_cache_tree(self.cfg, cache, start, path_nodes,
                                             n_accept)
