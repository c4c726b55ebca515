"""Training loop: CE loss (+ MoE load-balance aux), AdamW, remat — port of
``repro/train/trainer.py``.

The port's parameters are a :class:`~repro_torch.models.transformer.
Transformer` whose weights are buffers (the quantizer, the fault injector
and ``with_config`` share or replace them by identity).  Training
differentiates the floating-point leaves of that tree, named and ordered as
the reference pytree's leaves (:func:`train_leaves`), through
``torch.func.functional_call``: each step swaps detached leaves that
require a gradient into the model, takes the loss and their gradients
there, and writes the updated leaves back into the model, so the trained model is
the same ``Transformer`` that ``quantize_params`` and the engine take.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.model import forward
from repro_torch.models.transformer import Transformer, param_leaves
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         bias_corrections, cosine_lr)


def train_leaves(params: Transformer) -> Dict[str, torch.Tensor]:
    """Every floating-point leaf of the tree, by its reference path
    (``"layers/0/attn/q/w"``), in the reference's ``jax.tree.leaves``
    order."""
    return {path: t for path, _, _, t in param_leaves(params) if t.is_floating_point()}


def set_leaves(params: Transformer, leaves: Dict[str, torch.Tensor]) -> Transformer:
    """Write ``leaves`` (by path) into the tree in place; returns it."""
    for path, owner, name, _ in list(param_leaves(params)):
        if path in leaves:
            setattr(owner, name, leaves[path])
    return params


def loss_fn(params: Transformer, cfg, tokens, labels, aux_embeds=None, remat: bool = False):
    """Next-token CE over the valid labels (label −1 masks), in f32, plus
    the MoE layers' summed load-balance aux → (loss, (ce, aux))."""
    logits, aux = forward(params, tokens, aux_embeds=aux_embeds, remat=remat)
    valid = labels >= 0
    lab = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    ce = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    return ce + aux, (ce, aux)


class _ValueAndGrad(nn.Module):
    """:func:`loss_fn` of one model and its gradients with respect to
    ``leaves``, as a module for ``functional_call``: the gradients are
    taken inside the call, while the leaves are in the model, where a
    remat layer's recomputation reads them."""

    def __init__(self, model: Transformer, cfg, remat: bool):
        super().__init__()
        self.model, self.cfg, self.remat = model, cfg, remat

    def forward(self, tokens, labels, aux_embeds, leaves):
        loss, (ce, aux) = loss_fn(self.model, self.cfg, tokens, labels, aux_embeds,
                                  self.remat)
        return loss, ce, aux, torch.autograd.grad(loss, leaves, allow_unused=True)


def _on(x, device):
    """A batch entry (numpy or torch, or None) as a tensor on ``device``."""
    if x is None or isinstance(x, torch.Tensor):
        return x if x is None else x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


def value_and_grad(params: Transformer, cfg, batch: dict, remat: bool = False):
    """``((loss, (ce, aux)), grads)`` of :func:`loss_fn` on ``batch``
    (``tokens``, ``labels`` and optionally ``aux_embeds``, numpy or torch),
    with ``grads`` the gradient of every :func:`train_leaves` leaf, by
    path, in the leaf's dtype (zeros where the loss does not reach it)."""
    leaves = train_leaves(params)
    inputs = {k: t.detach().requires_grad_(True) for k, t in leaves.items()}
    dev = next(iter(leaves.values())).device
    tokens, labels, aux_embeds = (_on(batch.get(k), dev)
                                  for k in ("tokens", "labels", "aux_embeds"))
    with torch.enable_grad():
        loss, ce, aux, grads = torch.func.functional_call(
            _ValueAndGrad(params, cfg, remat),
            {"model." + k.replace("/", "."): t for k, t in inputs.items()},
            (tokens, labels, aux_embeds, list(inputs.values())))
    grads = {k: torch.zeros_like(t) if g is None else g
             for (k, t), g in zip(inputs.items(), grads)}
    return (loss.detach(), (ce.detach(), aux.detach())), grads


def make_train_step(cfg, opt_cfg: AdamWConfig, remat: bool = True, scan: bool = False,
                    graphs: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` is updated in place (its leaves replaced) and
    returned.

    ``remat=True`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): the policy of the
    reference's scanned layer body.  ``scan`` selects the reference's
    stacked-layer layout, which the port does not have; it means the same
    per-layer remat here, and changes nothing else.  On the card the step
    runs as a CUDA graph (:class:`CapturedTrainStep`); ``graphs=False``
    runs it eagerly there too (for checks)."""
    del scan
    if graphs:
        return CapturedTrainStep(cfg, opt_cfg, remat)

    def train_step(params: Transformer, opt_state: dict, batch: dict):
        (loss, (ce, aux)), grads = value_and_grad(params, cfg, batch, remat)
        new, opt_state, om = adamw_update(opt_cfg, train_leaves(params), grads, opt_state)
        set_leaves(params, new)
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux, **om}

    return train_step


class CapturedTrainStep:
    """The train step as a CUDA graph.

    Eager, a train step is bound by the host on the card: thousands of
    PyTorch ops against a device that finishes them sooner (``PERF.md``
    §5 has the times).  The first call for a model, optimizer state and batch
    shape runs eagerly on a side stream (a real step that warms the
    libraries), the second is captured and replayed, and every later call
    copies its batch into the graph's input tensors, fills the step's
    learning rate and bias corrections (``adamw_update``'s ``scalars``)
    and replays; another model, state or shape starts over.  A graph reads
    and writes fixed addresses, so this step updates the model's leaves
    and the moments in place (the eager step replaces them) and returns
    the loss, ce, aux and gradient norm as copies.  The arithmetic is the
    eager step's on the card, so replayed steps equal eager ones bit for
    bit.  On the CPU it runs the eager step."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, remat: bool):
        self.cfg, self.opt_cfg, self.remat = cfg, opt_cfg, remat
        self._eager = make_train_step(cfg, opt_cfg, remat, graphs=False)
        self.graph = None
        self._key = None
        self.launches = None

    def _run(self, params, opt_state, batch, scalars):
        """One step that writes the leaves and moments in place."""
        leaves = train_leaves(params)
        (loss, (ce, aux)), grads = value_and_grad(params, self.cfg, batch, self.remat)
        new, new_opt, om = adamw_update(self.opt_cfg, leaves, grads, opt_state, scalars)
        names = list(leaves)
        for group in ("mu", "nu"):
            torch._foreach_copy_([opt_state[group][k] for k in names],
                                 [new_opt[group][k] for k in names])
        torch._foreach_copy_([leaves[k] for k in names], [new[k] for k in names])
        return loss, ce, aux, om["grad_norm"]

    def __call__(self, params: Transformer, opt_state: dict, batch: dict):
        dev = params.embed.w.device
        if dev.type != "cuda":
            return self._eager(params, opt_state, batch)
        step = int(opt_state["step"]) + 1
        lr = cosine_lr(self.opt_cfg, step)
        key = (id(params), id(opt_state["mu"]),
               tuple((k, np.shape(v)) for k, v in batch.items() if v is not None))
        if key != self._key:
            self.graph = self._key = None
        if self.graph is None:
            if self._key is None:           # the first step: eager, on a side stream
                self._key = key
                self._inputs = {k: _on(v, dev) for k, v in batch.items() if v is not None}
                self._scalars = [torch.zeros((), dtype=torch.float32, device=dev)
                                 for _ in range(3)]
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    out = self._run(params, opt_state, self._inputs, None)
                torch.cuda.current_stream(dev).wait_stream(side)
                opt_state["step"] = step
                return params, opt_state, self._metrics(out, lr)
            self.graph = torch.cuda.CUDAGraph()
            with ops.launches_apart() as launches:
                with torch.cuda.graph(self.graph):
                    self._out = self._run(params, opt_state, self._inputs, self._scalars)
            self.launches = launches
        for k, t in self._inputs.items():
            t.copy_(_on(batch[k], dev))
        for t, v in zip(self._scalars, (lr, *bias_corrections(self.opt_cfg, step))):
            t.fill_(float(v))
        self.graph.replay()
        ops.add_launches(self.launches)
        opt_state["step"] = step
        return params, opt_state, self._metrics([t.clone() for t in self._out], lr)

    @staticmethod
    def _metrics(out, lr) -> dict:
        loss, ce, aux, gnorm = out
        return {"loss": loss, "ce": ce, "aux": aux, "lr": float(lr), "grad_norm": gnorm}


class Trainer:
    def __init__(self, model, opt_cfg: AdamWConfig = AdamWConfig(), remat: bool = False):
        self.model = model
        self.opt_cfg = opt_cfg
        self._step = make_train_step(model.cfg, opt_cfg, remat)

    def init(self, generator: torch.Generator):
        """Seeded random params (the generator on the model's device) and
        their optimizer state."""
        params = self.model.init_params(generator)
        return params, adamw_init(train_leaves(params))

    def fit(self, params: Transformer, opt_state: dict, data_iter, steps: int,
            log_every: int = 10, log_fn=print):
        """``steps`` train steps on ``data_iter``'s batches → (the trained
        ``Transformer``, opt_state, history): one dict (loss, ce, aux, lr,
        grad_norm, step, wall_s) at the first step and every
        ``log_every``-th."""
        history = []
        t0 = time.perf_counter()
        for i in range(steps):
            batch = next(data_iter)
            params, opt_state, m = self._step(params, opt_state, batch)
            if (i + 1) % log_every == 0 or i == 0:
                m = {k: float(v) for k, v in m.items()}
                m["step"] = i + 1
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
                if log_fn:
                    log_fn(f"step {i+1:5d}  loss {m['loss']:.4f}  ce {m['ce']:.4f} "
                           f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}")
        return params, opt_state, history
