"""Inspect the enhanced-SmoothQuant calibration on the PyTorch/CUDA port:
how smoothing factors migrate quantization difficulty from activations to
weights (paper Eq. 5), and what that buys in logit fidelity.

Runs on the CUDA card by default (the quantized forward through the
hand-written kernels); ``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python examples/torch/quantize_and_inspect.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import QuantConfig
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.quant.apply import quantize_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer


@torch.inference_mode()
def kl_and_top1(model, params, qparams, seed=2):
    toks = torch.as_tensor(next(lm_batches(4, 64, model.cfg.vocab_size, seed=seed))["tokens"],
                           device=model.device)
    lf, _ = model.forward(params, toks)
    lq, _ = model.forward(qparams, toks)
    p = torch.softmax(lf, -1)
    kl = float(torch.mean(torch.sum(p * (torch.log(p + 1e-9) - torch.log_softmax(lq, -1)), -1)))
    t1 = float(torch.mean((lf.argmax(-1) == lq.argmax(-1)).float()))
    return kl, t1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=1.5e-3, warmup_steps=min(10, args.steps // 5),
                                    total_steps=args.steps))
    params, opt = tr.init(torch.Generator(device=dev).manual_seed(0))
    params, _, _ = tr.fit(params, opt, lm_batches(8, 96, cfg.vocab_size),
                          steps=args.steps, log_every=args.steps, log_fn=None)

    # calibrate
    collect = {}
    model.forward(params, torch.as_tensor(
        next(lm_batches(4, 96, cfg.vocab_size, seed=1))["tokens"], device=dev), collect=collect)
    print(f"calibrated {len(collect)} apply-sites, e.g.:")
    for path in list(collect)[:4]:
        a = collect[path].float()
        print(f"  {path:28s} act |max| range [{float(a.min()):.3f}, {float(a.max()):.3f}] "
              f"(outlier ratio {float(a.max() / a.median()):.1f}x)")

    out = {}
    for alpha in (0.0, 0.5, 0.8):
        q = quantize_params(params, collect, QuantConfig(alpha=alpha))
        kl, t1 = out[f"alpha={alpha:.1f}"] = kl_and_top1(model, params, q)
        print(f"alpha={alpha:.1f}  KL={kl:.3e}  top-1 agreement={t1:.3f}")
    q = quantize_params(params, None, QuantConfig())
    kl, t1 = out["no calib"] = kl_and_top1(model, params, q)
    print(f"no calib   KL={kl:.3e}  top-1 agreement={t1:.3f}")
    return out


if __name__ == "__main__":
    main()
