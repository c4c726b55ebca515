"""Dense feed-forward network (gated or plain) — port of
``repro/models/ffn.py``."""
from __future__ import annotations

from torch import nn

from repro_torch.models.common import activation
from repro_torch.models.linear import Linear
from repro_torch.quant.smoothquant import record_act_stats


def apply_linear(lin: nn.Module, x, collect=None, path: str = ""):
    """Apply a (bf16 or W8A8) linear, recording calibration stats first."""
    if collect is not None:
        record_act_stats(collect, path, x)
    return lin(x)


class FFN(nn.Module):
    def __init__(self, cfg, up: nn.Module, down: nn.Module, gate: nn.Module | None):
        super().__init__()
        self.cfg = cfg
        self.up, self.down, self.gate = up, down, gate

    @classmethod
    def init(cls, generator, cfg, device):
        dt, bias, D, F = cfg.dtype, cfg.ffn_bias, cfg.d_model, cfg.d_ff
        # the reference draws gate, up, down from split keys in that order
        gate = Linear.init(generator, D, F, bias, dt, device) if cfg.glu else None
        up = Linear.init(generator, D, F, bias, dt, device)
        down = Linear.init(generator, F, D, bias, dt, device)
        return cls(cfg, up, down, gate)

    def forward(self, x, collect=None, path: str = ""):
        up = apply_linear(self.up, x, collect, f"{path}/up")
        if self.gate is not None:
            h = activation(self.cfg, apply_linear(self.gate, x, collect, f"{path}/gate")) * up
        else:
            h = activation(self.cfg, up)
        return apply_linear(self.down, h, collect, f"{path}/down")
