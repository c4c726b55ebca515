"""Serving launcher — port of ``repro/launch/serve.py``.

Serves synthetic prompts with seeded random weights, or with the weights
of an ``.npz`` checkpoint (``--ckpt``: one the port's or the reference's
train CLI wrote), and prints throughput and acceptance length.
``--kv-layout contiguous`` (the default) runs ``SpecEngine.generate``;
``--kv-layout paged`` routes the batch through the continuous-batching
scheduler as per-request generations (``SpecEngine.generate_requests``)
over the paged, prefix-shared KV cache, as the reference does.  ``--serve`` runs the async front-end instead: a
``StreamingServer`` on the wall clock takes a Poisson stream of
``--requests`` requests, streams each one's tokens, and prints the
``ServerMetrics`` summary (TTFT, ITL, deadlines, the robustness counters);
``--fault-plan`` injects seeded faults, ``--trace-out`` writes a
Chrome/Perfetto trace, ``--metrics-out`` the summary as JSON and
``--prom-out`` its Prometheus exposition.  Runs on the CUDA card unless
``--device cpu`` is given; with no card it exits with an error rather than
falling back.  On the card the decode step is a CUDA graph
(``serving/graphs.py``): the last line reports the programs built
(``step_traces``) and the time their captures took, inside the run's time.

  python -m repro_torch.launch.serve --arch quasar-paper-7b \
      --verifier w8a8 --drafter ngram --gamma 5 --batch 4 \
      --prompt-len 1024 --new-tokens 64 --kv-cache int8
  python -m repro_torch.launch.serve --arch quasar-paper-7b \
      --verifier w4a8 --tree-branches 3,2,1,1 --kv-cache int8
  python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu \
      --drafter pruned --pruned-retention 0.5
  python -m repro_torch.launch.serve --arch quasar-paper-7b --kv-layout paged \
      --batch 12 --prompt-len 1024 --new-tokens 64
  python -m repro_torch.launch.serve --arch zamba2-2.7b --verifier w8a8 \
      --drafter ngram --batch 4 --prompt-len 1024 --new-tokens 64
  python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu \
      --mode spec --task humaneval --attn-impl jnp

``--task`` picks the prompts' repetition preset (``data.task_prompts``);
``--mode`` is the reference's deprecated alias for ``--drafter``
(``spec`` → ngram); ``--attn-impl`` picks the cache reads' path: ``auto``
is the hand-written ``flash_decode`` kernels on the card (``attn=pallas``)
and their plain versions on the CPU (``attn=ref``), ``pallas`` the kernels
(refused on the CPU), ``jnp`` the plain PyTorch attention, chosen only by
the flag; the header's ``attn=`` names the path taken.

The SSM and hybrid models (``mamba2-370m``, ``zamba2-2.7b``) run on the
contiguous cache; the engine refuses token trees, ``--kv-layout paged`` and
``--serve`` for them (their caches are recurrent), as the reference does.
  python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu \
      --serve --requests 8 --arrival-rate 4 --fault-plan nan_verify@2 \
      --trace-out trace.json --metrics-out metrics.json --prom-out metrics.prom
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.core.protocols import available_drafters, available_verifiers
from repro_torch.data import task_prompts
from repro_torch.data.synthetic import TASK_REPETITION
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving.engine import LEGACY_MODES, GenResult, SpecEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.request import GenerationRequest, RequestResult
from repro_torch.serving.server import ServerConfig, StreamingServer
from repro_torch.serving.trace import Tracer
from repro_torch.train.checkpoint import load_checkpoint

WEIGHT_SEED = 0
TASK = "gsm8k"                     # --task's default
# the cache reads' attention path (models/attention.py) that --attn-impl
# picks: auto is pallas on the card and ref on the CPU
ATTN_PATHS = {"pallas": "the hand-written flash_decode kernels (CUDA)",
              "ref": "the flash_decode kernels' plain versions",
              "jnp": "the plain PyTorch attention"}


@dataclass
class ScheduledResult:
    """What ``--kv-layout paged`` serves: one result per request, in order."""

    results: List[RequestResult]
    wall_s: float                        # generate_requests, admissions included
    group_stats: List[dict] = field(default_factory=list)
    step_s: float = 0.0                  # mean decode step (telemetry)
    capture_s: float = 0.0               # CUDA graph capture, inside wall_s

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


@dataclass
class ServedResult:
    """What ``--serve`` serves: the handles in submission order, the metrics
    summary and the wall time of the whole stream."""

    handles: list
    summary: dict
    wall_s: float
    metrics: object = None               # the ServerMetrics the summary came from
    step_traces: int = 0
    capture_s: float = 0.0
    fault_log: List[dict] = field(default_factory=list)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--verifier", default="w8a8", choices=list(available_verifiers()))
    ap.add_argument("--drafter", default=None, choices=list(available_drafters()),
                    help="default: ngram, or ngram-tree with --tree-branches")
    ap.add_argument("--mode", default=None, choices=list(LEGACY_MODES),
                    help="deprecated alias: spec|vanilla|pruned -> --drafter")
    ap.add_argument("--attn-impl", default="auto", choices=["auto", "jnp", "pallas"],
                    help="cache-read attention: auto = the flash_decode kernels on the "
                         "card, their plain version on the CPU; pallas = the kernels "
                         "(refused on the CPU); jnp = the plain PyTorch attention")
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
    ap.add_argument("--task", default=TASK,
                    help=f"prompt repetition preset ({', '.join(TASK_REPETITION)}; "
                         "another name takes the default 0.3)")
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
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (.npz, the reference's format: "
                         "repro_torch.launch.train or repro.launch.train) to serve")
    ap.add_argument("--serve", action="store_true",
                    help="async front-end: run a StreamingServer on the wall clock, "
                         "submit a Poisson arrival stream, stream tokens per request, "
                         "print the metrics summary (repro_torch.serving.server)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests in the --serve arrival stream")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="--serve Poisson arrival rate (requests/s)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="--serve per-request SLO deadline in seconds "
                         "(default: no deadline)")
    ap.add_argument("--admission", default="edf", choices=["fifo", "edf"],
                    help="--serve admission policy within priority class")
    ap.add_argument("--no-shed", action="store_true",
                    help="--serve: keep past-deadline queued work instead of "
                         "shedding it")
    ap.add_argument("--request-timeout", type=float, default=None, metavar="S",
                    help="--serve: fail any request older end-to-end than S "
                         "seconds (RequestTimeout)")
    ap.add_argument("--collapse-window", type=int, default=0, metavar="N",
                    help="--serve: acceptance-collapse detector window (N decode "
                         "steps; 0 = off); a quantized-verifier lane whose mean "
                         "acceptance sits below --collapse-threshold for a full "
                         "window is re-prepared (re-quantized)")
    ap.add_argument("--collapse-threshold", type=float, default=0.05, metavar="T",
                    help="--serve: mean accepted tokens per row-step below which "
                         "the collapse detector trips")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="--serve: inject faults from a seeded FaultPlan spec "
                         "(seam@i / seam~p, comma-separated, e.g. "
                         "'step@3,alloc~0.05'; repro_torch.serving.faults)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for --fault-plan")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event / Perfetto JSON of the run "
                         "(request lifecycle, scheduler ticks, decode/prefill/swap "
                         "spans)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics summary as JSON (--serve: the "
                         "ServerMetrics summary; otherwise the engine's "
                         "acceptance telemetry)")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="--serve: write the metrics in Prometheus text "
                         "exposition format (ServerMetrics.expose_text)")
    args = ap.parse_args(argv)
    # --tree-branches implies the tree drafter; reject combinations that
    # would silently ignore the template
    args.tree_branches = (tuple(int(b) for b in args.tree_branches.split(","))
                          if args.tree_branches else None)
    if args.drafter is None:
        args.drafter = LEGACY_MODES.get(args.mode) or (
            "ngram-tree" if args.tree_branches is not None else "ngram")
    if args.tree_branches is not None:
        if args.gamma is not None:
            ap.error("--gamma conflicts with --tree-branches: the template "
                     "fixes the draft length (nodes - 1)")
        if args.drafter != "ngram-tree":
            ap.error(f"--tree-branches is only read by tree drafters; "
                     f"drafter {args.drafter!r} would silently ignore it")
    if args.gamma is None:
        args.gamma = 5
    if args.fault_plan is not None and not args.serve:
        ap.error("--fault-plan needs --serve")
    if args.prom_out is not None and not args.serve:
        ap.error("--prom-out needs --serve (ServerMetrics)")
    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        ap.error(str(exc))
    if args.attn_impl == "pallas" and args.device.type != "cuda":
        ap.error("--attn-impl pallas runs the hand-written flash_decode kernels, which "
                 "need the card; on the CPU take auto or jnp")
    return args


def serve_stream(engine: SpecEngine, params, prompts: np.ndarray, args,
                 tracer: Optional[Tracer]) -> ServedResult:
    """``--serve``: a Poisson stream of ``args.requests`` requests through a
    ``StreamingServer``, each consumed token by token on this thread."""
    cfg_srv = ServerConfig(
        batch_slots=args.batch, max_prompt_len=args.prompt_len,
        max_new_tokens=args.new_tokens, admission=args.admission,
        shed_late=not args.no_shed, request_timeout_s=args.request_timeout,
        collapse_window=args.collapse_window,
        collapse_threshold=args.collapse_threshold)
    faults = (FaultPlan.parse(args.fault_plan, seed=args.fault_seed)
              if args.fault_plan else None)
    gaps = np.random.default_rng(0).exponential(1.0 / max(args.arrival_rate, 1e-9),
                                                size=args.requests)
    t0 = time.perf_counter()
    srv = StreamingServer(engine, params, cfg_srv, tracer=tracer, faults=faults)
    with srv:
        handles = []
        for i in range(args.requests):
            time.sleep(gaps[i])
            handles.append(srv.submit(GenerationRequest(
                prompts[i % len(prompts)], args.new_tokens, seed=i,
                deadline_s=args.deadline)))
        for h in handles:
            chunks = list(h.tokens())         # blocking per-token stream
            try:
                res = h.result(timeout=600.0)
            except Exception as exc:  # noqa: BLE001 — a failed request is contained
                print(f"req {h.rid}: failed ({type(exc).__name__}: {exc})")
            else:
                print(f"req {h.rid}: {h.status}, {len(chunks)} chunks, "
                      f"{res.new_tokens if res else 0} tokens")
    wall = time.perf_counter() - t0
    srv.metrics.check_conservation()
    summary = srv.metrics.summary()
    c, lat = summary["counters"], summary["latency"]
    print(f"served {c['completed']}/{c['submitted']} (shed {c['shed']}, failed "
          f"{c['failed']}) in {wall:.2f}s wall")
    rb = {k: v for k, v in summary["robustness"].items() if v}
    if rb:
        print("robustness: " + ", ".join(f"{k}={v}" for k, v in sorted(rb.items())))
    ttft, itl = lat["ttft_s"], lat["itl_s"]
    if ttft.get("n"):
        print(f"ttft p50={ttft['p50']:.3f}s p99={ttft['p99']:.3f}s  "
              f"itl p50={itl.get('p50', float('nan')):.4f}s")
    if summary["deadlines"]["with_deadline"]:
        print(f"deadline hit-rate: {summary['deadlines']['hit_rate']:.3f}")
    print(f"step_traces={engine.step_traces}  capture_ms={1e3 * engine.capture_s:.1f}")
    return ServedResult(handles, summary, wall, srv.metrics, engine.step_traces,
                        engine.capture_s, list(faults.log) if faults is not None else [])


def dump_observability(args, engine: SpecEngine, tracer: Optional[Tracer],
                       metrics=None) -> None:
    """Write the ``--trace-out`` / ``--metrics-out`` / ``--prom-out`` files."""
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace: {args.trace_out} ({len(tracer.events)} events)")
    if args.metrics_out:
        payload = (metrics.summary() if metrics is not None
                   else {"acceptance": engine.telemetry.summary()})
        with open(args.metrics_out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"metrics: {args.metrics_out}")
    if args.prom_out:
        with open(args.prom_out, "w") as f:
            f.write(metrics.expose_text())
        print(f"prometheus: {args.prom_out}")


@torch.no_grad()
def main(argv=None) -> GenResult | ScheduledResult | ServedResult:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache, attn_impl=args.attn_impl)
    dev = args.device
    model = Model(cfg, device=dev)
    if args.ckpt:
        tree = load_checkpoint(args.ckpt)
        params = from_jax_params(tree.get("params", tree), cfg, device=dev)
        print(f"serving {args.ckpt}")
    else:
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
    if not args.serve:
        # the server keeps the raw params for its bf16 fallback lane
        params = engine.prepare_params(params)     # the original is dropped here
    prompts = torch.as_tensor(task_prompts(args.task, args.batch, args.prompt_len,
                                           cfg.vocab_size), device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    attn = args.attn_impl if args.attn_impl != "auto" else (
        "pallas" if dev.type == "cuda" else "ref")
    print(f"arch={cfg.name} verifier={engine.verifier.name} "
          f"drafter={engine.drafter.name} kv_cache={cfg.kv_cache_dtype} "
          f"kv_layout={args.kv_layout} attn={attn} ({ATTN_PATHS[attn]}) device={where}")
    tracer = Tracer() if args.trace_out else None
    if args.serve:
        served = serve_stream(engine, params, prompts.cpu().numpy(), args, tracer)
        dump_observability(args, engine, tracer, served.metrics)
        return served
    if args.kv_layout == "paged":
        # paged is a serving-path layout: the batch goes through the
        # continuous-batching scheduler as per-request generations
        reqs = [GenerationRequest(p, args.new_tokens, seed=i)
                for i, p in enumerate(prompts.cpu().numpy())]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = engine.generate_requests(params, reqs, tracer=tracer)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tkey = f"{engine.drafter.name}:{engine.verifier.name}"
        sr = ScheduledResult(out, time.perf_counter() - t0, engine.group_stats,
                             engine.telemetry.summary()[tkey]["step_s"]["mean"],
                             engine.capture_s)
        g = sr.group_stats[0]
        print(f"served {len(reqs)} requests through {g['slots']} slots "
              f"({g['pool_blocks']} blocks of {g['block_size']}, peak {g['peak_blocks']}, "
              f"shared {g['shared_blocks']}): {sr.new_tokens} tokens in {sr.wall_s:.3f}s "
              f"({sr.tokens_per_s:.1f} tok/s, {where})")
        print(f"verify steps={sr.steps}  mean acceptance length L={sr.mean_accept_len:.3f}  "
              f"step_traces={engine.step_traces}  capture_ms={1e3 * sr.capture_s:.1f}")
        dump_observability(args, engine, tracer)
        return sr
    r = engine.generate(params, prompts, args.new_tokens)
    print(f"prefill {args.batch}x{args.prompt_len - 1} tokens in {r.prefill_s:.3f}s; "
          f"generated {r.new_tokens} tokens in {r.wall_s:.3f}s "
          f"({r.tokens_per_s:.1f} tok/s, {where})")
    print(f"verify steps={r.steps}  mean acceptance length L={r.mean_accept_len:.3f}  "
          f"step_traces={engine.step_traces}  capture_ms={1e3 * r.capture_s:.1f}")
    dump_observability(args, engine, tracer)
    return r


if __name__ == "__main__":
    main()
