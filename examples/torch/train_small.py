"""End-to-end training driver on the PyTorch/CUDA port: train a ~135M-param
model (SmolLM-135M architecture) for a few hundred steps on the synthetic
Markov corpus and checkpoint it in the reference's ``.npz`` format (which
``python -m repro_torch.launch.serve --ckpt`` serves).

The default runs the reduced config; ``--full`` trains the real 135M
configuration.  Runs on the CUDA card by default (each step a CUDA graph
there); ``--device cpu`` runs on the CPU.

Run:  PYTHONPATH=src python examples/torch/train_small.py [--steps 300] [--full]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.bridge import to_tree
from repro_torch.configs import get_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="train the real smollm-135m config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_smollm.npz"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = cfg.reduced()
    model = Model(cfg, device=dev)
    print(f"arch={cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
          f"{'full' if args.full else 'reduced'}, {dev})")

    trainer = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=min(20, args.steps // 5),
                                         total_steps=args.steps))
    params, opt = trainer.init(torch.Generator(device=dev).manual_seed(0))
    data = lm_batches(args.batch, args.seq_len, cfg.vocab_size, seed=0)
    params, opt, hist = trainer.fit(params, opt, data, steps=args.steps, log_every=20)
    save_checkpoint(args.ckpt, {"params": to_tree(params), "step": args.steps})
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; "
          f"checkpoint: {args.ckpt} ({os.path.getsize(args.ckpt)/1e6:.1f} MB)")
    return dict(history=hist, ckpt=args.ckpt)


if __name__ == "__main__":
    main()
