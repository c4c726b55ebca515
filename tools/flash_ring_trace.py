"""Where a block of the ring read's kernel spends its time, phase by phase.

    python3 tools/flash_ring_trace.py [--out FILE] [--cross]

Builds a copy of ``src/repro_torch/csrc/flash_decode.cu`` in which thread 0
of every block of ``flash_sliced_kernel`` writes ``%globaltimer`` at the
boundaries of its phases into a device array (into ``csrc/_build``, beside
the kernels' libraries), loads it in place of the ``flash_decode`` library,
and runs the ring read once (after three warm-up calls and an L2 flush, as
``chip_smoke.time_ms``) at chip_smoke's ring rows: the 7B's 4224-slot ring
at B 4 and T 6 (bf16 and int8 K/V), B 1, T 1 and a ring filled by a
1024-token prefill; with ``--cross``, the cross-attention read (the same
body without positions, whose first phase holds only the query rows'
copies) at whisper's (4, 6, 12/12, 1500, 64) and vision's (4, 6, 64/8,
1600, 128) instead.  For each it prints the kernel's span, the median
block's duration and each phase's median and 10th/90th percentile across
blocks (the merge's phases over the blocks that merged), and when the
blocks and the merging blocks end.  The phases: the skip test's loads, the
first chunks' copies issued, the query rows landed, the barrier, the first
chunk landed, the rest of the sweep, the fold (accumulators to shared
memory, weights, sums and stores), the fence and the count, the merge
(maxima and sums loaded, weights, outputs).  The timestamps add a few
instructions per phase; the timer ticks in nanoseconds but may advance in
coarser steps.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SLOTS = 16                    # timestamps per block
# (line holding this text, code put after it)
MARKS = [("__shared__ int is_last;", "TRACE(0)"),
         ("const int nlive = __popc(todo);", "TRACE(1)"),
         ("for (int i = 0; i < RING_STAGES - 1; ++i) issue(i);", "TRACE(2)"),
         ("cp_async_wait<RING_STAGES - 1>();  // the query rows' group has landed", "TRACE(3)"),
         ("__syncthreads();                   // ... for every warp", "TRACE(4)"),
         ("bar_sync(1 + slice, sl_threads);   // ... for the slice", "if (i == 0) { TRACE(5) }"),
         ("__syncthreads();     // every slice has left its stages", "TRACE(6)")]
PHASES = [(1, 0, "skip test loads"), (2, 1, "first copies issued"), (3, 2, "query rows landed"),
          (4, 3, "barrier"), (5, 4, "first chunk landed"), (6, 5, "rest of the sweep"),
          (7, 6, "fold: acc to smem"), (8, 7, "fold: weights"), (9, 8, "fold: sums, stores"),
          (10, 9, "fence and count"), (11, 10, "merge: m, l loaded"), (12, 11, "merge: weights"),
          (13, 12, "merge: outputs")]
PRELUDE = """
__device__ unsigned long long g_ring_trace[32768 * 16];
#define TRACE(ph) if (threadIdx.x == 0) g_ring_trace[(blockIdx.x + gridDim.x * (blockIdx.y + \\
    gridDim.y * blockIdx.z)) * 16 + (ph)] = ring_clock();
__device__ __forceinline__ unsigned long long ring_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
EXPORTS = """
extern "C" int ring_trace_copy(void* dst, size_t n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_ring_trace, n));
}
extern "C" int ring_trace_clear(const void* zeros, size_t n) {
  return static_cast<int>(cudaMemcpyToSymbol(g_ring_trace, zeros, n));
}
"""


def instrumented(src: str) -> str:
    """The kernel source with TRACE(i) at each phase boundary."""
    lines = src.split("\n")

    def at(text):
        hits = [i for i, ln in enumerate(lines) if text in ln]
        if not hits:
            raise SystemExit(f"flash_ring_trace: no line holds {text!r}")
        return hits[0]

    for text, code in MARKS:
        lines.insert(at(text) + 1, "  " + code)
    # after the sweep: the fold's barriers, the fence, the count, the merge
    swept = at("TRACE(6)")
    fence = at("__threadfence();  // this block's partials")
    count = at("is_last = atomicAdd")
    reset = at("if (tid == 0) *counter = 0;")
    syncs = [i for i, ln in enumerate(lines) if ln.strip() == "__syncthreads();" and i > swept]
    merge = [i for i in syncs if i > count + 1]
    marks = {syncs[0]: 7, syncs[1]: 8, fence - 1: 9, count + 1: 10, merge[0]: 11,
             merge[-1]: 12, reset - 1: 13}
    for i in sorted(marks, reverse=True):
        lines.insert(i + 1, f"  TRACE({marks[i]})")
    out = "\n".join(lines)
    return out.replace("namespace {\n", "namespace {\n" + PRELUDE, 1) + EXPORTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--cross", action="store_true", help="the cross read's rows instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_ring_trace: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (cross_plan, flash_decode, flash_decode_cross,
                                                  launch_plan)

    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = ops.BUILD_DIR / "flash_ring_trace.cu"
    lib_path = ops.BUILD_DIR / "libflash_ring_trace.so"
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    cu.write_text(instrumented((csrc / "flash_decode.cu").read_text()))
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib_path), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    for fn in (lib.ring_trace_copy, lib.ring_trace_clear):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    ops._LIBS["flash_decode"] = lib

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config(cs.ARCH)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    zeros = np.zeros(32768 * SLOTS, dtype=np.uint64)
    past = cs.RING_PROMPT + 100
    report = {}

    def ring_row(label, b, t, int8, fill):
        q, k, v, qpos, kw = cs.ring_inputs(torch, dev, g, b, t, cfg.num_heads, cfg.num_kv_heads,
                                           cfg.head_dim, int8, fill)
        plan = launch_plan(cfg.num_heads // cfg.num_kv_heads * t, k.shape[1], cfg.head_dim,
                           torch.bfloat16, k.dtype, ring=True)
        return label, lambda: flash_decode(q, k, v, qpos, **kw), plan, b * cfg.num_kv_heads

    def cross_row(label, b, t, hq, hkv, sa, dh):
        q = torch.randn(b, t, hq, dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        return label, lambda: flash_decode_cross(q, k, v), cross_plan(hq // hkv * t, sa, dh), b * hkv

    if args.cross:
        rows = [cross_row("whisper B4 T6", 4, 6, 12, 12, 1500, 64),
                cross_row("vision B4 T6", 4, 6, 64, 8, 1600, 128)]
    else:
        rows = [ring_row("B4 T6 bf16", 4, 6, False, past), ring_row("B4 T6 int8", 4, 6, True, past),
                ring_row("B1 T6 bf16", 1, 6, False, past), ring_row("B4 T1 bf16", 4, 1, False, past),
                ring_row("B4 T6 bf16 partly filled", 4, 6, False, cs.RING_FILL)]
    for label, run, plan, heads in rows:
        n = heads * plan.nsplit
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        if lib.ring_trace_clear(zeros.ctypes.data, zeros.nbytes):
            raise RuntimeError("flash_ring_trace: clearing the trace failed")
        flush.zero_()
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        buf = np.zeros_like(zeros)
        if lib.ring_trace_copy(buf.ctypes.data, buf.nbytes):
            raise RuntimeError("flash_ring_trace: reading the trace failed")
        tr = buf[:n * SLOTS].reshape(n, SLOTS).astype(np.int64)
        us = (tr - tr[:, 0].min()) / 1e3
        merged = tr[:, 13] > 0
        swept = tr[:, 5] > 0                   # blocks with a live chunk
        end = np.where(merged, us[:, 13], us[:, 10])
        row = dict(blocks=n, threads=plan.threads, smem=plan.smem, span_us=float(end.max()),
                   block_us_median=float(np.median(us[:, 10] - us[:, 0])), phases={})
        print(f"== {label}: {n} blocks of {plan.threads} threads, span {row['span_us']:.2f} us, "
              f"block median {row['block_us_median']:.2f} us")
        for a, z, name in PHASES:
            sel = merged if a >= 11 else (swept if a in (5, 6) else np.ones(n, bool))
            if not sel.any():
                continue
            d = us[sel, a] - us[sel, z]
            row["phases"][name] = [float(np.median(d)), float(np.percentile(d, 10)),
                                   float(np.percentile(d, 90))]
            print(f"   {name:22s} median {np.median(d):6.2f}  p10 {np.percentile(d, 10):6.2f}  "
                  f"p90 {np.percentile(d, 90):6.2f} us")
        row["blocks_end_us_deciles"] = [float(x) for x in np.percentile(us[:, 10], range(0, 101, 10))]
        row["merging_blocks_end_us"] = sorted(float(x) for x in us[merged, 13])
        print("   blocks end (deciles, us):", " ".join(f"{x:.1f}" for x in row["blocks_end_us_deciles"]))
        print("   merging blocks end (us):", " ".join(f"{x:.1f}" for x in row["merging_blocks_end_us"][-8:]))
        report[label] = row
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, rows=report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(dict(device=out["device"], nvidia_smi=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
