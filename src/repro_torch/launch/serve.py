"""Serving launcher — port of the batch and paged paths of
``repro/launch/serve.py``.

Serves one batch of synthetic prompts with seeded random weights and
prints throughput and acceptance length.  ``--kv-layout contiguous`` (the
default) runs ``SpecEngine.generate``; ``--kv-layout paged`` routes the
batch through the continuous-batching scheduler as per-request
generations (``SpecEngine.generate_requests``) over the paged,
prefix-shared KV cache, as the reference does.  Runs on the CUDA card
unless ``--device cpu`` is given; with no card it exits with an error
rather than falling back.

  python -m repro_torch.launch.serve --arch quasar-paper-7b \
      --verifier w8a8 --drafter ngram --gamma 5 --batch 4 \
      --prompt-len 1024 --new-tokens 64 --kv-cache int8
  python -m repro_torch.launch.serve --arch quasar-paper-7b \
      --verifier w4a8 --tree-branches 3,2,1,1 --kv-cache int8
  python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu \
      --drafter pruned --pruned-retention 0.5
  python -m repro_torch.launch.serve --arch quasar-paper-7b --kv-layout paged \
      --batch 12 --prompt-len 1024 --new-tokens 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import List

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.core.protocols import available_drafters, available_verifiers
from repro_torch.data import task_prompts
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving.engine import GenResult, SpecEngine
from repro_torch.serving.request import GenerationRequest, RequestResult

WEIGHT_SEED = 0
TASK = "gsm8k"


@dataclass
class ScheduledResult:
    """What ``--kv-layout paged`` serves: one result per request, in order."""

    results: List[RequestResult]
    wall_s: float                        # generate_requests, admissions included
    group_stats: List[dict] = field(default_factory=list)
    step_s: float = 0.0                  # mean decode step (telemetry)

    @property
    def new_tokens(self) -> int:
        return sum(r.new_tokens for r in self.results)

    @property
    def tokens_per_s(self) -> float:
        return self.new_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_accept_len(self) -> float:
        return sum(r.accept_len for r in self.results) / len(self.results)

    @property
    def steps(self) -> int:
        return max(r.steps for r in self.results)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--verifier", default="w8a8", choices=list(available_verifiers()))
    ap.add_argument("--drafter", default=None, choices=list(available_drafters()),
                    help="default: ngram, or ngram-tree with --tree-branches")
    ap.add_argument("--kv-cache", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--gamma", type=int, default=None,
                    help="draft tokens per step (default 5); a tree template "
                         "fixes its own")
    ap.add_argument("--tree-branches", default=None,
                    help="token-tree template, per-depth branch factors, e.g. 3,2,1,1")
    ap.add_argument("--pruned-retention", type=float, default=0.75,
                    help="share of the layers the pruned drafter keeps")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--kv-layout", default="contiguous", choices=["contiguous", "paged"],
                    help="serving-path cache layout; 'paged' routes the batch through "
                         "the continuous-batching scheduler with block-granular KV "
                         "allocation (core/paged_cache.py)")
    ap.add_argument("--kv-block-size", type=int, default=128,
                    help="tokens per paged KV block (--kv-layout paged)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="--kv-layout paged: disable the prefix cache (refcounted "
                         "block sharing of common prompt prefixes)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="--kv-layout paged: never evict running slots to the host "
                         "swap pool; denied admissions wait for capacity instead")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card is required) or cpu")
    args = ap.parse_args(argv)
    # --tree-branches implies the tree drafter; reject combinations that
    # would silently ignore the template
    args.tree_branches = (tuple(int(b) for b in args.tree_branches.split(","))
                          if args.tree_branches else None)
    if args.drafter is None:
        args.drafter = "ngram-tree" if args.tree_branches is not None else "ngram"
    if args.tree_branches is not None:
        if args.gamma is not None:
            ap.error("--gamma conflicts with --tree-branches: the template "
                     "fixes the draft length (nodes - 1)")
        if args.drafter != "ngram-tree":
            ap.error(f"--tree-branches is only read by tree drafters; "
                     f"drafter {args.drafter!r} would silently ignore it")
    if args.gamma is None:
        args.gamma = 5
    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        ap.error(str(exc))
    return args


def main(argv=None) -> GenResult | ScheduledResult:
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
                      drafter=args.drafter, verifier=args.verifier,
                      tree_branches=args.tree_branches,
                      pruned_retention=args.pruned_retention,
                      kv_layout=args.kv_layout, kv_block_size=args.kv_block_size,
                      kv_prefix_sharing=not args.no_prefix_sharing,
                      kv_preempt=not args.no_preempt)
    engine = SpecEngine(model, scfg)
    params = engine.prepare_params(params)     # the original is dropped here
    prompts = torch.as_tensor(task_prompts(TASK, args.batch, args.prompt_len,
                                           cfg.vocab_size), device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name} verifier={engine.verifier.name} "
          f"drafter={engine.drafter.name} kv_cache={cfg.kv_cache_dtype} "
          f"kv_layout={args.kv_layout} device={where}")
    if args.kv_layout == "paged":
        # paged is a serving-path layout: the batch goes through the
        # continuous-batching scheduler as per-request generations
        reqs = [GenerationRequest(p, args.new_tokens, seed=i)
                for i, p in enumerate(prompts.cpu().numpy())]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = engine.generate_requests(params, reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tkey = f"{engine.drafter.name}:{engine.verifier.name}"
        sr = ScheduledResult(out, time.perf_counter() - t0, engine.group_stats,
                             engine.telemetry.summary()[tkey]["step_s"]["mean"])
        g = sr.group_stats[0]
        print(f"served {len(reqs)} requests through {g['slots']} slots "
              f"({g['pool_blocks']} blocks of {g['block_size']}, peak {g['peak_blocks']}, "
              f"shared {g['shared_blocks']}): {sr.new_tokens} tokens in {sr.wall_s:.3f}s "
              f"({sr.tokens_per_s:.1f} tok/s, {where})")
        print(f"verify steps={sr.steps}  mean acceptance length L={sr.mean_accept_len:.3f}")
        return sr
    r = engine.generate(params, prompts, args.new_tokens)
    print(f"prefill {args.batch}x{args.prompt_len - 1} tokens in {r.prefill_s:.3f}s; "
          f"generated {r.new_tokens} tokens in {r.wall_s:.3f}s "
          f"({r.tokens_per_s:.1f} tok/s, {where})")
    print(f"verify steps={r.steps}  mean acceptance length L={r.mean_accept_len:.3f}")
    return r


if __name__ == "__main__":
    main()
