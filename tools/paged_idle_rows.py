"""Check that a paged MoE run below its expert count's capacity factor
gives the same tokens run after run, with the colliding scratch writes of
idle rows left to the device and with ``last_wins``.

    python3 tools/paged_idle_rows.py [--layers N]

``moonshot-v1-16b-a3b`` at full width, ``--layers`` of its layers (default
8), seeded random bf16 weights, W8A8, capacity factor 1.25 (the config's):
12 gsm8k-preset requests of 1024 tokens through 8 paged slots (block 128),
ngram γ 5, 64 new tokens, greedy — the MoE paged run of ``chip_smoke.py``
at a cut depth.  Idle slots point at scratch block 0 and write their
windows to the same rows, and an idle row's routing takes expert slots
from the live rows, so the live tokens depend on which colliding write
sticks unless ``write_cache_paged`` gives every colliding write the last
writer's values.  For each mode ("off": the attention layer's writes with
``last_wins=False``; "on": as the model runs them) it runs
``generate_requests`` eagerly, through graphs, eagerly, through graphs,
and prints the share of equal tokens between every two runs; last, one
JSON object {device, nvidia_smi, off, on}.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("paged_idle_rows: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.models import Model, attention
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    ops.build()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=args.layers,
                              kv_cache_dtype="bf16")
    model = Model(cfg, device=dev)
    raw = model.init_params(torch.Generator(device=dev).manual_seed(0))
    prep = SpecEngine(model, SpecConfig(verifier="w8a8")).prepare_params(raw)
    del raw
    reqs = [GenerationRequest(p, 64, seed=i)
            for i, p in enumerate(task_prompts("gsm8k", 12, 1024, cfg.vocab_size))]
    scfg = SpecConfig(gamma=5, drafter="ngram", verifier="w8a8", kv_layout="paged",
                      kv_block_size=128)
    write = attention.write_cache_paged
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    try:
        for mode in ("off", "on"):
            attention.write_cache_paged = write if mode == "on" else (
                lambda c, k, v, s, bt, last_wins=False: write(c, k, v, s, bt))
            runs = [np.stack([r.tokens for r in SpecEngine(model, scfg, graphs=graphs)
                              .generate_requests(prep, reqs)])
                    for graphs in (False, True, False, True)]
            out[mode] = [[float((a == b).mean()) for b in runs] for a in runs]
            print(f"{mode}: share of equal tokens between runs (eager, graphs, eager, "
                  f"graphs): {json.dumps(out[mode])}", flush=True)
    finally:
        attention.write_cache_paged = write
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
