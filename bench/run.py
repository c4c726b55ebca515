"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one
cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's traffic and weights from ``--seed``, builds and warms the
served path (set-up), measures for ``--seconds`` seconds, checks what the
timed path served against the plain reference, and prints one JSON line
last on standard output.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones from a run that also profiles a
short sub-window after the measured one.  Exits non-zero with no result
when there is no CUDA card (or fewer than the cell asks for), or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded.

Not for the benchmark's own runs: ``--control 1`` also runs the control of
the comparison (the program's W4A8 verifier in the W8A8 one's place) and
reports its gaps.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache a run writes stays in the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH / ".cache" / "torch_extensions"))
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BENCH / ".cache" / "inductor"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

from benchkit import imports  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchkit.spec import Bench
    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchkit import cell
    result = cell.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, control=bool(args.control))
    found = imports.forbidden()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
