"""Offline weight preparation (paper §3.3) — port of
``repro/quant/apply.py``: replace every quantizable :class:`Linear` of a
parameter tree with its smoothed W8A8 form, or with W4A8 where
``QuantConfig.w_bits == 4`` and din is even (an odd din stays W8A8, so one
tree may mix the two).  An MoE layer's batched experts
(:class:`ExpertLinear`) always become W8A8, under ``w_bits == 4`` too: the
reference checks for 3-D weights before it looks at ``w_bits``."""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core.config import QuantConfig
from repro_torch.models.linear import ExpertLinear, Linear
from repro_torch.quant.int4 import quantize_linear_w4
from repro_torch.quant.int8 import quantize_batched, quantize_linear
from repro_torch.quant.smoothquant import smoothing_factors

# Param-path fragments that must stay in the model dtype: tiny and/or
# precision critical.  Norms and conv are not GEMMs.
_EXCLUDE = ("router", "embed", "norm", "conv", "A_log", "D_skip", "dt_bias")


def _excluded(path: str, qcfg: QuantConfig) -> bool:
    if qcfg.quantize_embedding and "embed" in path:
        return False
    return any(tag in path for tag in _EXCLUDE)


def quantize_params(params: nn.Module,
                    act_stats: Optional[Dict[str, torch.Tensor]] = None,
                    qcfg: QuantConfig = QuantConfig()) -> nn.Module:
    """Return a new parameter tree with W8A8 (or W4A8) linears; ``params`` is left as
    it is, and tensors that stay unquantized are shared with it.

    ``act_stats`` maps apply-site paths (``"layers/0/attn/q"``, as recorded
    during calibration) to per-input-channel activation maxima; linears
    without stats get s = 1.  Already-quantized trees pass through.
    """
    act_stats = act_stats or {}
    memo = {id(t): t for t in params.buffers()}   # share, never copy, tensors
    out = copy.deepcopy(params, memo)
    for name, mod in list(out.named_modules()):
        path = name.replace(".", "/")
        if isinstance(mod, (Linear, ExpertLinear)) and not _excluded(path, qcfg):
            s = smoothing_factors(mod.w, act_stats.get(path), qcfg.alpha)
            if isinstance(mod, ExpertLinear):
                quant = quantize_batched
            elif qcfg.w_bits == 4 and mod.w.shape[0] % 2 == 0:
                quant = quantize_linear_w4
            else:
                quant = quantize_linear
            parent_name, _, attr = name.rpartition(".")
            setattr(out.get_submodule(parent_name), attr, quant(mod, s))
    return out
