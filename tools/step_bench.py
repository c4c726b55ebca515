"""Time the 7B verify step of a tree of the port, eager and through CUDA
graphs: unprofiled step ms, device busy ms per step and kernel launches
per step.

    python3 tools/step_bench.py [--src DIR] [--label NAME] [--steps N] [--out FILE]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one chip call can time two trees in turns (parent, change, change,
parent: one process each).  For the spec W8A8, spec W4A8 and (3,2,1,1)
tree W8A8 runs of ``chip_smoke.py`` (``quasar-paper-7b``, seeded random
weights, batch 4, 1024-token prompts, ngram γ 5, bf16 KV cache, greedy),
it runs ``chip_smoke.step_window`` once with an eager engine
(``graphs=False``) and once through graphs (the default), in the same
process: two warm-up steps (the eager first step, then the capture),
``--steps`` steps timed on the host clock with no profiler (the unprofiled
step; beside it the process's CPU time per step, the host work, which other
load on the host's cores inflates less), then ``chip_smoke.PROFILE_STEPS``
steps under torch.profiler (device busy ms per step, device events only)
with the launch counters zeroed before them.  The rows' budget
(``chip_smoke.BUDGET`` new tokens) outlasts every step taken.  A tree whose
engine has no ``graphs`` keyword (before the port had graphs) gets the
eager rows only.  Prints one line per run and mode and, last, a JSON object
{label, device, nvidia_smi, runs: {run: {mode: {step_ms, cpu_ms,
device_busy_ms_per_step, device_idle_share, launches_per_step, ...}}}};
``--out`` also writes it to a file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = {                       # run -> (verifier, drafter, tree branches)
    "spec_w8a8": ("w8a8", "ngram", None),
    "spec_w4a8": ("w4a8", "ngram", None),
    "tree_w8a8": ("w8a8", "ngram-tree", (3, 2, 1, 1)),
}


def step_times(torch, cs, steps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    dev = torch.device("cuda", 0)
    cfg = get_config(cs.ARCH)
    model = Model(cfg, device=dev)
    raw = model.init_params(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.as_tensor(task_prompts("gsm8k", cs.B, cs.PROMPT, cfg.vocab_size),
                              device=dev, dtype=torch.int32)
    modes = {"eager": {"graphs": False}, "graph": {}}
    if "graphs" not in inspect.signature(SpecEngine).parameters:
        modes = {"eager": {}}
    prepared, runs = {}, {}
    for run, (verifier, drafter, branches) in RUNS.items():
        scfg = SpecConfig(gamma=cs.GAMMA, drafter=drafter, verifier=verifier,
                          tree_branches=branches)
        if verifier not in prepared:
            prepared[verifier] = SpecEngine(model, scfg).prepare_params(raw)
        runs[run] = {}
        for mode, kw in modes.items():
            engine = SpecEngine(model, scfg, **kw)
            runs[run][mode] = cs.step_window(torch, engine, prepared[verifier], prompts, steps)
            torch.cuda.empty_cache()
    return runs


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
    runs = step_times(torch, cs, args.steps)
    for run, modes in runs.items():
        for mode, r in modes.items():
            print(f"  {args.label} {run} {mode}: step {r['step_ms']:.2f} ms (CPU "
                  f"{r['cpu_ms']:.2f} ms), device busy {r['device_busy_ms_per_step']} "
                  f"ms/step, idle {r['device_idle_share']}, launches/step "
                  f"{r['launches_per_step']}", flush=True)
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
