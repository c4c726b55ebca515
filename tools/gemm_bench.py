"""Time the port's ``int8_matmul`` and ``int4_matmul`` at the 7B main-path
shapes.

    python3 tools/gemm_bench.py [--src DIR] [--label NAME] [--out FILE] [--profile]
                                [--flush write|read]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one chip call can time two trees in turns (parent, change, change,
parent: one process each, since a process holds one ``repro_torch``).
Uses ``chip_smoke.py``'s shapes, inputs and timing (CUDA events, L2 flushed
before every launch, median of 50, 20 at ``lm_head`` and prefill): the 7B
linears at the chain window (M 24: q/o, k/v, gate/up, down, lm_head),
gate/up at vanilla (M 4), the paged chain (48), the tree (88) and the paged
tree (176) windows, the tree's ``lm_head`` (88), a prefill GEMM (4092),
and gate/up at M 12, 30, 60 and 110, which fall between the built widths;
int8 then int4 (the packed weight random bytes, every nibble value).  Each
output is held bit-equal to
the plain version before it is timed; for ``int8_matmul``
``torch._int_mm`` with the same epilogue is timed beside it (it takes
more than 16 rows only: none at M 4; no PyTorch call takes packed int4),
and the host's enqueue time of a call (median, ms).  With
``--profile``, the device kernels one call launches (torch.profiler, 5
calls); with ``--flush read``, L2 is emptied by reading a buffer instead
of zeroing one, so the kernel evicts clean lines only.  Prints one line
per kernel and shape and, last, a JSON object {label, device, nvidia_smi,
flush, ms: {kernel: {shape: ms}}, host_ms, int_mm_ms, kernels_per_call}
(host_ms and kernels_per_call also by kernel); ``--out`` also writes it
to a file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def shapes(cfg, b: int, gamma: int, tree_nodes: int, prompt: int):
    """(label, M, K, N) of the phase, in chip_smoke.py's order first."""
    D, FF, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    m, mt = b * (gamma + 1), b * tree_nodes
    return [("q/o M24", m, D, D), ("k/v M24", m, D, kv), ("gate/up M24", m, D, FF),
            ("down M24", m, FF, D), ("lm_head M24", m, D, V),
            ("prefill M4092", b * (prompt - 1), D, FF),
            ("gate/up M4", b, D, FF), ("gate/up M48", 2 * m, D, FF),
            ("gate/up M88", mt, D, FF), ("gate/up M176", 2 * mt, D, FF),
            ("lm_head M88", mt, D, V),
            # between the built wgmma widths (8, 24, 48, 96, 192, 256): the
            # cost of rounding M up to a coarser width
            ("gate/up M12", 12, D, FF), ("gate/up M30", 30, D, FF),
            ("gate/up M60", 60, D, FF), ("gate/up M110", 110, D, FF)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also the device kernels of one call (torch.profiler)")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="empty L2 before each launch by zeroing a 256 MB buffer, as "
                         "chip_smoke.py does (the kernel's reads then also evict dirty "
                         "lines), or by reading it (clean lines)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("gemm_bench: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_ref
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    dev = torch.device("cuda", 0)
    cfg = get_config(cs.ARCH)
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    if args.flush == "read":
        class ReadFlush:          # chip_smoke.time_ms calls flush.zero_()
            def zero_(self, buf=flush.view(torch.int32)):
                return buf.amax()
        flush = ReadFlush()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kernels = {"int8": (int8_matmul, int8_matmul_ref, 1),
               "int4": (int4_matmul, int4_matmul_ref, 2)}
    ms, host_ms, int_mm, per_call = ({name: {} for name in kernels} for _ in range(4))
    nodes = TreeTemplate(cs.TREE).num_nodes
    for name, (fn, ref, per_byte) in kernels.items():
        for label, m, k, n in shapes(cfg, cs.B, cs.GAMMA, nodes, cs.PROMPT):
            xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            lo = -127 if per_byte == 1 else -128       # int4: every nibble value
            w = torch.randint(lo, 128, (n, k // per_byte), generator=g, device=dev,
                              dtype=torch.int8)
            dx = torch.rand(m, generator=g, device=dev) * 1e-2
            dw = torch.rand(n, generator=g, device=dev) * 1e-3
            y = fn(xq, w, dx, dw)
            torch.cuda.synchronize()
            if not torch.equal(y, ref(xq, w, dx, dw)):
                raise AssertionError(f"{name}_matmul {label} differs from its plain version")

            def library():
                acc = torch._int_mm(xq, w.t())
                return (acc.float() * dx[:, None] * dw[None, :]).to(torch.bfloat16)

            iters = 20 if n == cfg.vocab_size or m > 256 else 50
            host = []
            ms[name][label] = cs.time_ms(torch, lambda: fn(xq, w, dx, dw), iters, flush, host)
            host_ms[name][label] = statistics.median(host)
            # torch._int_mm takes more than 16 rows only, and no packed int4
            int_mm[name][label] = (cs.time_ms(torch, library, iters, flush)
                                   if m > 16 and name == "int8" else None)
            extra = ""
            if args.profile:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn(xq, w, dx, dw)
                    torch.cuda.synchronize()
                dev_events = [e.name for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA]
                per_call[name][label] = len(dev_events) / 5
                kinds = sorted({nm.split("(")[0].split("<")[0] for nm in dev_events})
                extra = f"  kernels/call {per_call[name][label]:g} {kinds}"
            lib = "none" if int_mm[name][label] is None else f"{int_mm[name][label]:.4f}"
            print(f"  {name} {label:16s} ({m},{k},{n}) {ms[name][label]:.4f} ms  _int_mm {lib}"
                  f"  host {host_ms[name][label]:.4f}" + extra, flush=True)
            del xq, w, y
    out = dict(label=args.label, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               flush=args.flush, ms=ms, host_ms=host_ms, int_mm_ms=int_mm,
               kernels_per_call=per_call)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
