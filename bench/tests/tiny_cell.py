"""A copy of the benchmark in a temporary folder with one tiny cell of a
reduced configuration (2 layers, d 128, vocab 512, float32), for runs of
the whole harness on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

MIXES = {
    "backlog": {"kind": "backlog", "slots": 3, "depth": 2, "prompt_len": 24, "task": "gsm8k",
                "new_tokens": 12},
    "poisson": {"kind": "poisson", "slots": 3, "rate": 6.0, "prompt_len": [8, 24],
                "new_tokens": [2, 12], "tasks": ["mtbench", "alpaca"], "warm_s": 1.0,
                "tail_s": 4.0, "shape_seed": 0},
}


def make(tmp: Path, kind: str = "backlog", gap_limit: float = 0.05, rate: float = None):
    """(root, cell name) of a temporary benchmark holding one tiny cell;
    ``rate`` overrides the open-loop mix's."""
    bdir = tmp / "bench"
    shutil.copytree(BENCH, bdir, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg = json.loads((BENCH / "configs" / "quasar-paper-7b.json").read_text())
    m = dict(cfg["model"], num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             head_dim=32, d_ff=256, vocab_size=512, dtype="float32")
    cfg.update(model=m, name="tiny", correct={"logit_gap": gap_limit})
    (bdir / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = dict(MIXES[kind], **({"rate": rate} if rate else {}))
    (bdir / "traffic" / f"tiny-{kind}.json").write_text(json.dumps(mix))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                     "reduced": [], "why": "a reduced configuration for CPU runs"}]
    b["workloads"] = [{"name": "tiny-cell", "config": "tiny", "traffic": f"tiny-{kind}",
                       "chips": 1, "why": "CPU run of the harness"}]
    for metric in b["end_to_end"] + b["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = ["tiny-cell"]
    # every reader in bench/metrics, those no cell of BENCHMARK.json reports too
    named = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    for f in sorted((BENCH / "metrics").glob("*.py")):
        if f.stem not in named:
            b["per_layer"].append({"name": f.stem, "unit": "x", "better": "lower",
                                   "source": "host_clock", "layer": "test", "moves": "setup_s",
                                   "workloads": ["tiny-cell"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp, "tiny-cell"


def run(tmp: Path, seconds: float = 2.0, seed: int = 2 ** 31 + 11, drain_cap: float = 5.0,
        trace: bool = False, **kw):
    import time

    import torch

    from benchkit import cell

    torch.set_num_threads(2)          # several test processes share the CPU
    from benchkit.spec import Bench

    root, name = make(tmp, **kw)
    bench = Bench(root, root / "bench")
    return cell.run(bench, name, seed, seconds, trace, "cpu", time.perf_counter(),
                    drain_cap=drain_cap)
