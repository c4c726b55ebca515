"""Training launcher — port of ``repro/launch/train.py``.

Trains one model of the registry on the synthetic Markov corpus
(``data.lm_batches``) with AdamW and per-layer remat, and with ``--ckpt``
saves ``{"params", "step"}`` as an ``.npz`` in the reference's format,
which ``repro_torch.launch.serve --ckpt`` (and, for f32 trees, the
reference's serve CLI) serves.  Runs on the CUDA card unless ``--device
cpu`` is given; with no card it exits with an error rather than falling
back.  ``--scan`` asks for the reference's stacked-layer layout, which the
port does not have: it trains the per-layer layout with the same remat.
Beside the reference's flags, ``--warmup`` sets the warm-up steps (the
reference's ``min(20, steps // 5)`` by default) and ``--markov-alpha``
the corpus' chance of following the chain (``lm_batches``' 0.9 by
default).  The last line sums the run up: the median step time after the
warm-up, training tokens/s, the peak memory on the card, the loss from
step 1 to the mean of the last 10 steps, and the largest gradient norm
(before the clip).

  python -m repro_torch.launch.train --arch smollm-135m --steps 400 --batch 16 \\
      --seq-len 256 --lr 6e-3 --markov-alpha 0.97 --ckpt smollm.npz
  python -m repro_torch.launch.train --arch smollm-135m --reduced --device cpu \\
      --steps 3 --batch 2 --seq-len 32
"""
from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass, field

import torch

from repro_torch.bridge import to_tree
from repro_torch.configs import get_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.models.transformer import Transformer
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step, train_leaves

WEIGHT_SEED = 0


@dataclass
class TrainRun:
    """What :func:`main` trained: the model, its optimizer state and
    config, the step function (on the card, the captured graph), and per
    step the loss, the gradient norm and the seconds (synchronized)."""
    params: Transformer
    opt_state: dict
    opt_cfg: AdamWConfig
    step: object
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    step_s: list = field(default_factory=list)
    peak_gb: float | None = None

    @property
    def step_ms(self) -> float:
        """The median step after the warm-up (all steps if it is longer)."""
        return 1e3 * statistics.median(self.step_s[self.opt_cfg.warmup_steps:] or self.step_s)

    @property
    def last10(self) -> float:
        return statistics.fmean(self.losses[-10:])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warm-up steps (default: min(20, steps // 5), the reference's)")
    ap.add_argument("--markov-alpha", type=float, default=0.9,
                    help="the corpus' chance of following the Markov chain")
    ap.add_argument("--scan", action="store_true",
                    help="the reference's stacked-layer layout; the port has none and "
                         "trains the per-layer layout with the same remat")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card is required) or cpu")
    args = ap.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        ap.error(str(exc))
    return args


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = args.device
    cuda = dev.type == "cuda"
    model = Model(cfg, device=dev)
    where = torch.cuda.get_device_name(dev) if cuda else "CPU"
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M layout=loop device={where}")

    warmup = min(20, args.steps // 5) if args.warmup is None else args.warmup
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=warmup, total_steps=args.steps)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(WEIGHT_SEED))
    opt = adamw_init(train_leaves(params))
    step = make_train_step(cfg, opt_cfg, remat=True, scan=args.scan)
    run = TrainRun(params, opt, opt_cfg, step)

    data = lm_batches(args.batch, args.seq_len, cfg.vocab_size, seed=0,
                      markov_alpha=args.markov_alpha)
    losses, norms = [], []
    for i in range(args.steps):
        batch = next(data)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        if cuda:
            torch.cuda.synchronize(dev)
        run.step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if (i + 1) % 10 == 0 or i == 0:
            print(f"step {i+1:5d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  gnorm {float(m['grad_norm']):.2f}")
    run.params, run.opt_state = params, opt
    run.losses = torch.stack(losses).float().tolist()
    run.grad_norms = torch.stack(norms).float().tolist()
    if cuda:
        run.peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    peak = f"{run.peak_gb:.2f} GB" if cuda else "not measured"
    print(f"trained {args.steps} steps on {where}: step {run.step_ms:.1f} ms (median after "
          f"the warm-up), {args.batch * args.seq_len / (run.step_ms / 1e3):.0f} tokens/s, "
          f"peak {peak}; loss {run.losses[0]:.4f} -> {run.last10:.4f} (last 10), "
          f"largest gradient norm {max(run.grad_norms):.2f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": to_tree(params), "step": args.steps})
        print(f"saved {args.ckpt}")
    return run


if __name__ == "__main__":
    main()
