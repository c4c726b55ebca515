"""Time the 7B verify step of a tree of the port: unprofiled step ms, device
busy ms per step and kernel launches per step.

    python3 tools/step_bench.py [--src DIR] [--label NAME] [--steps N] [--out FILE]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one chip call can time two trees in turns (parent, change, change,
parent: one process each).  For the spec W8A8 and spec W4A8 runs of
``chip_smoke.py`` (``quasar-paper-7b``, seeded random weights, batch 4,
1024-token prompts, ngram γ 5, bf16 KV cache, greedy), it steps the engine
as ``SpecEngine`` does (each step ends in the host read of the lengths):
two warm-up steps, ``--steps`` steps timed on the host clock with no
profiler (the unprofiled step; beside it the process's CPU time per step,
the host work, which other load on the host's cores inflates less), then
``chip_smoke.PROFILE_STEPS`` steps under torch.profiler (device busy ms per
step, device events only) with the launch counters zeroed before them.  The
rows' budget (256 new tokens) outlasts every step taken, so no row finishes
inside the window.  Prints one line per verifier and, last, a JSON object
{label, device, nvidia_smi, runs: {verifier: {step_ms, cpu_ms,
device_busy_ms_per_step, launches_per_step}}}; ``--out`` also writes it to a
file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUDGET = 256


def step_times(torch, cs, verifier: str, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    dev = torch.device("cuda", 0)
    cfg = get_config(cs.ARCH)
    model = Model(cfg, device=dev)
    engine = SpecEngine(model, SpecConfig(gamma=cs.GAMMA, drafter="ngram", verifier=verifier))
    params = engine.prepare_params(
        model.init_params(torch.Generator(device=dev).manual_seed(0)))
    prompts = torch.as_tensor(task_prompts("gsm8k", cs.B, cs.PROMPT, cfg.vocab_size),
                              device=dev, dtype=torch.int32)
    full = lambda v: torch.full((cs.B,), v, dtype=torch.int32, device=dev)  # noqa: E731
    with torch.inference_mode():
        state = engine._init_state(params, prompts, full(cs.PROMPT),
                                   full(cs.PROMPT + BUDGET),
                                   cs.PROMPT + BUDGET + engine.drafter.gamma + 2,
                                   prng.row_generators(range(cs.B), dev))
        for _ in range(2):
            state = engine._step(params, state)
            state["length"].cpu()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(steps):
            state = engine._step(params, state)
            state["length"].cpu()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        cpu_ms = 1e3 * (time.process_time() - c0) / steps
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(cs.PROFILE_STEPS):
                state = engine._step(params, state)
                state["length"].cpu()
            torch.cuda.synchronize()
        launches = {k: v / cs.PROFILE_STEPS for k, v in ops.launch_counts().items()}
    busy_ms, _ = cs.device_time(torch, prof)
    return dict(step_ms=step_ms, cpu_ms=cpu_ms,
                device_busy_ms_per_step=busy_ms / cs.PROFILE_STEPS,
                launches_per_step=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("step_bench: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    runs = {}
    for verifier in ("w8a8", "w4a8"):
        runs[verifier] = r = step_times(torch, cs, verifier, args.steps)
        print(f"  {args.label} {verifier}: step {r['step_ms']:.2f} ms (CPU "
              f"{r['cpu_ms']:.2f} ms), device busy "
              f"{r['device_busy_ms_per_step']:.2f} ms/step, launches/step "
              f"{r['launches_per_step']}", flush=True)
        torch.cuda.empty_cache()
    out = dict(label=args.label, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               runs=runs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
