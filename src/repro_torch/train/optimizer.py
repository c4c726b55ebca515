"""AdamW with a cosine schedule — port of ``repro/train/optimizer.py``,
written over a dict of tensors (not ``torch.optim``) in the reference's
arithmetic and order:

* the moments are f32 whatever the param dtype (bf16 params, f32 state);
* the gradients are clipped by their global norm before the moments;
* only leaves with ``ndim >= 2`` are decayed (norms, biases, gates and the
  SSM's vectors are not), and the decay is added to the update, not
  multiplied into the param;
* the new param is ``(p.f32 − lr·(m̂/(√v̂+ε) + wd·p.f32)).to(p.dtype)``.

``torch.optim.AdamW`` differs in each of these.  The scalars (the learning
rate and the bias corrections) are f32 values computed on the host from
the step count, ``b ** step`` through libm's ``powf`` as the reference's
``jnp.power`` on the CPU; the elementwise work runs as ``torch._foreach_*``
over the leaves.  On the CPU the update is bit-equal to the reference's
jitted one below the clip (``tests/test_torch_train.py``); on the card the
scalars are device tensors, as a captured step needs them
(``train/trainer.make_train_step(graphs=True)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.common import powf


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> np.float32:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``, then a cosine to
    0 at ``total_steps``; f32 arithmetic, as the reference's."""
    f = np.float32
    step = f(int(step))
    warm = step / f(max(cfg.warmup_steps, 1))
    t = (step - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * np.clip(t, f(0.0), f(1.0))))
    return f(cfg.lr) * (warm if step < cfg.warmup_steps else cos)


def adamw_init(params: Dict[str, torch.Tensor]) -> dict:
    """f32 zero moments beside each leaf, and the step count (an int)."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return {"mu": zeros, "nu": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": 0}


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves, in their order, of each leaf's sum
    of squares in f32."""
    total = None
    for g in grads:
        s = g.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def bias_corrections(cfg: AdamWConfig, step: int):
    """(1 − b1^step, 1 − b2^step) in f32, the powers through libm's
    ``powf``."""
    return (np.float32(1) - powf(cfg.b1, np.float32(step)),
            np.float32(1) - powf(cfg.b2, np.float32(step)))


def adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: dict, scalars=None):
    """One step → (new params, new opt_state, {"lr", "grad_norm"}); the
    inputs are left as they are.

    ``scalars``: the step's (lr, 1 − b1^step, 1 − b2^step) as 0-d device
    tensors, for a step captured as a CUDA graph, which reads them where
    they are filled before each replay; by default they are computed on
    the host from ``opt_state["step"]``."""
    names = list(params)
    step = int(opt_state["step"]) + 1
    dev = params[names[0]].device
    if scalars is None:
        lr = float(cosine_lr(cfg, step))
        # 0-d device tensors, not Python scalars: CUDA divides by a host
        # scalar through its reciprocal
        c1, c2 = (torch.tensor(c, device=dev) for c in bias_corrections(cfg, step))
        if dev.type == "cuda":        # the arithmetic of a captured step
            lr = torch.tensor(np.float32(lr), device=dev)
    else:
        lr, c1, c2 = scalars

    gnorm = _global_norm([grads[k] for k in names])
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32, device=dev)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    g = torch._foreach_mul([grads[k].float() for k in names], scale)

    b1, b2 = cfg.b1, cfg.b2
    # torch.add(a, b, alpha=s) is one fused multiply-add, s·b + a, as the
    # reference's compiled update has it (XLA contracts each product into
    # the sum that reads it, and folds (m/c1)/den into m/(c1·den))
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                            [opt_state["mu"][k] for k in names], alpha=b1)
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g),
                            [opt_state["nu"][k] for k in names], alpha=b2)
    den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
    torch._foreach_add_(den, cfg.eps)
    u = torch._foreach_div(mu, torch._foreach_mul(den, c1))
    p32 = [params[k].float() for k in names]
    decay = [i for i, k in enumerate(names) if params[k].dim() >= 2]
    if decay:
        torch._foreach_add_([u[i] for i in decay], [p32[i] for i in decay],
                            alpha=cfg.weight_decay)
    if isinstance(lr, torch.Tensor):  # the card: lr on the device
        new = torch._foreach_sub(p32, torch._foreach_mul(u, lr))
    else:
        new = torch._foreach_add(p32, u, alpha=-lr)
    new_params = {k: t.to(params[k].dtype) for k, t in zip(names, new)}
    return (new_params, {"mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)),
                         "step": step},
            {"lr": lr, "grad_norm": gnorm})
