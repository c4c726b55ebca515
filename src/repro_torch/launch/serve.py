"""Serving launcher — port of the batch path of ``repro/launch/serve.py``.

Serves one batch of synthetic prompts with seeded random weights through
``SpecEngine.generate`` and prints throughput and acceptance length.  Runs
on the CUDA card unless ``--device cpu`` is given; with no card it exits
with an error rather than falling back.

  python -m repro_torch.launch.serve --arch quasar-paper-7b \
      --verifier w8a8 --drafter ngram --gamma 5 --batch 4 \
      --prompt-len 1024 --new-tokens 64 --kv-cache int8
  python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.core.protocols import available_drafters, available_verifiers
from repro_torch.data import task_prompts
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving.engine import GenResult, SpecEngine

WEIGHT_SEED = 0
TASK = "gsm8k"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--verifier", default="w8a8", choices=list(available_verifiers()))
    ap.add_argument("--drafter", default="ngram", choices=list(available_drafters()))
    ap.add_argument("--kv-cache", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--gamma", type=int, default=5)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card is required) or cpu")
    args = ap.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        ap.error(str(exc))
    return args


def main(argv=None) -> GenResult:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache)
    dev = args.device
    model = Model(cfg, device=dev)
    print("no checkpoint: serving seeded random-init weights")
    gen = torch.Generator(device=dev)
    gen.manual_seed(WEIGHT_SEED)
    params = model.init_params(gen)

    scfg = SpecConfig(gamma=args.gamma, temperature=args.temperature,
                      drafter=args.drafter, verifier=args.verifier)
    engine = SpecEngine(model, scfg)
    params = engine.prepare_params(params)     # the original is dropped here
    prompts = torch.as_tensor(task_prompts(TASK, args.batch, args.prompt_len,
                                           cfg.vocab_size), device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name} verifier={engine.verifier.name} "
          f"drafter={engine.drafter.name} kv_cache={cfg.kv_cache_dtype} device={where}")
    r = engine.generate(params, prompts, args.new_tokens)
    print(f"prefill {args.batch}x{args.prompt_len - 1} tokens in {r.prefill_s:.3f}s; "
          f"generated {r.new_tokens} tokens in {r.wall_s:.3f}s "
          f"({r.tokens_per_s:.1f} tok/s, {where})")
    print(f"verify steps={r.steps}  mean acceptance length L={r.mean_accept_len:.3f}")
    return r


if __name__ == "__main__":
    main()
