"""Where a block of the batched expert GEMM (``int8_matmul_batched``) spends
its time, phase by phase, and the GEMM's time in a tree of the port.

    python3 tools/batched_gemm_trace.py [--src DIR] [--label NAME] [--out FILE]
                                        [--no-trace] [--no-time] [--moe]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one chip call can trace and time two trees in turns (parent, change,
change, parent: one process each).

Trace: builds a copy of the tree's batched kernel source in which thread 0
of every block writes ``%globaltimer`` at the boundaries of its phases
into a device array (into ``csrc/_build``), loads it in place of the
kernel's library and runs the product once (after three warm-up calls and
an L2 flush, as ``chip_smoke.time_ms``) at moonshot's expert linears: the
prefill's tiled regime (64, 480, 2048, 1408) and (64, 480, 1408, 2048),
paged admission's C 120 and the decode chain's C 3.  A tree whose
``csrc/int8_batched.cu`` exists has the timestamps built in (``TRACE``
hooks, compiled with ``-DGEMM_TRACE``): a block's start, its item list
built, and for each (expert, tile) item it walks the item's start, its
first stage landed, its last product retired and its tile stored, then the
zero pass's end.  An older tree runs the batched product in
``csrc/int8_matmul.cu``'s one-tile-per-block kernel, and the marks are put
after its lines: start, ring initialised, first stage landed, last product
retired, tile stored.  For each row it prints the kernel's span, the
blocks and the SMs they ran on, each phase's median and 10th/90th
percentile across blocks (items), and when blocks start and end (deciles:
the waves of a one-tile-per-block grid, the tail of a persistent one).

Timing: each row again, and C 21, bit-equal to the plain version first,
then timed as ``chip_smoke.time_ms`` times kernel rows (CUDA events, L2
flushed before every launch, median of 20-50) beside a bf16 ``torch.bmm``
of the same shapes (the yardstick: no PyTorch call computes a batched int8
product with int32 sums), each at every expert's rows; in a tree whose
product takes ``rows``, also at the MoE runs' fills (``--moe``), at each
C that has some.

MoE runs (``--moe``, first, on an empty card): ``moonshot-v1-16b-a3b`` as
``chip_smoke.py``'s MoE phase builds it (MOE_LAYERS layers, the serve CLI's
weight seed, capacity factor 1.25), W8A8 at four runs: the ngram spec
(batch B), the tree (TREE), and both again paged (PAGED_REQUESTS requests
through 8 slots, block 128).  Each runs once eagerly with a pre-hook on
every MoE layer that routes the layer's rows again and records each
expert's fill min(count, C) by run and C (decode windows: spec C 3, tree
C 11, paged C 6, paged tree C 21; prefills: C 480, paged admissions C
120); the fills at the 10th, 50th and 90th percentile of each (run, C)'s
share of experts keeping a slot are timed (and kept in the JSON object).
Then each run's window through CUDA graphs (``chip_smoke.step_window``,
``tick_window`` for the paged ones): device busy ms per step, launches per
step, the batched kernel's device time per launch in the graph (an older
tree's only in the spec step, where no other kernel takes width 8).

Prints one line per row and, last, a JSON object {label, device,
nvidia_smi, ms, moe_busy_ms}; ``--out`` writes {label, device, nvidia_smi,
trace, ms, moe, fills} to a file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SLOTS = 128                   # timestamps per block
MAX_BLOCKS = 2048
# (expert count, C, K, N): moonshot's up/gate (K 2048 -> N 1408) and down
TRACE_ROWS = [(64, 480, 2048, 1408), (64, 480, 1408, 2048), (64, 120, 2048, 1408),
              (64, 3, 2048, 1408)]
TIME_ROWS = [(64, c, k, n) for c in (3, 21, 120, 480) for k, n in ((2048, 1408), (1408, 2048))]
PRELUDE = """
__device__ unsigned long long g_gemm_trace[%d * %d];
__device__ __forceinline__ unsigned long long gemm_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(slot) if (threadIdx.x == 0 && (slot) < %d && blockIdx.x < %d) \
    g_gemm_trace[blockIdx.x * %d + (slot)] = gemm_clock();
""" % (MAX_BLOCKS, SLOTS, SLOTS, MAX_BLOCKS, SLOTS)
EXPORTS = """
extern "C" int gemm_trace_copy(void* dst, size_t n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_gemm_trace, n));
}
extern "C" int gemm_trace_clear(const void* zeros, size_t n) {
  return static_cast<int>(cudaMemcpyToSymbol(g_gemm_trace, zeros, n));
}
"""
# the older tree: (line holding this text, code put after the statement)
OLD_MARKS = [("const Ring ring(smem_raw, stages);", "TRACE(0)"),
             ("if (threadIdx.x == 0) ring.init(1, 4 * WGS);", None),
             ("ring.wait_full(t);", "if (t == 0) { TRACE(2) }"),
             ("wgmma_wait<0>();", None),
             ("finish<NW, WGS, SWAP, 0>(", "TRACE(4)")]


def instrument_old(src: str) -> str:
    """``int8_matmul.cu`` with TRACE at the phases of its one-tile kernel:
    0 start, 1 ring initialised, 2 first stage landed, 3 last product
    retired, 4 tile stored; slot 5 the SM.  The grid is flattened to x."""
    lines = src.split("\n")

    def at(text, start=0):
        for i in range(start, len(lines)):
            if text in lines[i]:
                return i
        raise SystemExit(f"batched_gemm_trace: no line holds {text!r}")

    start = at(OLD_MARKS[0][0])
    inits = at(OLD_MARKS[1][0], start)          # its __syncthreads() follows
    wait = at(OLD_MARKS[2][0], start)
    drained = at(OLD_MARKS[3][0], wait) + 1     # fence_regs(acc) follows
    fin = at(OLD_MARKS[4][0], drained)
    while not lines[fin].rstrip().endswith(");"):
        fin += 1
    for i, code in sorted([(start, "TRACE(0)"), (inits + 1, "TRACE(1)"), (wait, OLD_MARKS[2][1]),
                           (drained, "TRACE(3)"), (fin, "TRACE(4) TRACE_SM(5)")],
                          reverse=True):
        lines.insert(i + 1, "  " + code)
    out = "\n".join(lines)
    flat = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
    prelude = (PRELUDE.replace("blockIdx.x *", flat + " *")
               .replace("blockIdx.x <", flat + " <") + _SM_OLD)
    return out.replace("namespace {\n", "namespace {\n" + prelude, 1) + EXPORTS


_SM_OLD = """
#define TRACE_SM(slot) if (threadIdx.x == 0 && (blockIdx.x + gridDim.x * (blockIdx.y + \\
    gridDim.y * blockIdx.z)) < %d) { unsigned s; asm volatile("mov.u32 %%0, %%%%smid;" \\
    : "=r"(s)); g_gemm_trace[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) \\
    * %d + (slot)] = s; }
""" % (MAX_BLOCKS, SLOTS)


def build(lib_name: str, src_dir: Path):
    """The instrumented library of the tree's batched kernel, loaded in place
    of ``lib_name``; returns (lib, new_layout)."""
    from repro_torch.kernels import ops

    csrc = src_dir / "repro_torch" / "csrc"
    new = (csrc / "int8_batched.cu").exists()
    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = ops.BUILD_DIR / "batched_gemm_trace.cu"
    so = ops.BUILD_DIR / "libbatched_gemm_trace.so"
    if new:
        text = (csrc / "int8_batched.cu").read_text()
        text = text.replace("namespace {\n", "namespace {\n" + PRELUDE, 1) + EXPORTS
        flags = ["-DGEMM_TRACE"]
    else:
        text, flags = instrument_old((csrc / "int8_matmul.cu").read_text()), []
    cu.write_text(text)
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, *flags, "-I", str(csrc), "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    err = getattr(lib, f"{lib_name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    for fn in (lib.gemm_trace_copy, lib.gemm_trace_clear):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    ops._LIBS[lib_name] = lib
    return lib, new


def _stats(d) -> list:
    return [float(np.median(d)), float(np.percentile(d, 10)), float(np.percentile(d, 90))]


def read_old(tr, us) -> dict:
    """Per block: ring fill (first stage landed after the ring's init), main
    loop, epilogue, lifetime; SM of each block."""
    ph = {"setup": us[:, 1] - us[:, 0], "ring fill": us[:, 2] - us[:, 1],
          "main loop": us[:, 3] - us[:, 2], "epilogue stores": us[:, 4] - us[:, 3],
          "block lifetime": us[:, 4] - us[:, 0]}
    sms = tr[:, 5]
    per_sm = np.bincount(sms.astype(np.int64), minlength=132)
    return dict(phases={k: _stats(v) for k, v in ph.items()},
                blocks_per_sm=[int(per_sm.min()), float(per_sm.mean()), int(per_sm.max())],
                starts=us[:, 0], ends=us[:, 4])


def read_new(tr, us, blocks: int) -> dict:
    """Slots: 0 start, 1 items built, 2 + 4i .. 5 + 4i item i's start, first
    stage landed, last product retired, stored; 126 walk done, 127 end."""
    items = {"item start to first stage landed": [], "main loop": [], "epilogue stores": [],
             "item total": []}
    first_fill, n_items = [], []
    for b in range(blocks):
        n = 0
        # thread 0 records the items its warpgroup walks (every item, or
        # every other one where two warpgroups take turns)
        for i in range(31):
            if tr[b, 5 + 4 * i] <= 0:
                continue
            s, landed, done, stored = us[b, 2 + 4 * i: 6 + 4 * i]
            items["item start to first stage landed"].append(landed - s)
            items["main loop"].append(done - landed)
            items["epilogue stores"].append(stored - done)
            items["item total"].append(stored - s)
            if n == 0:
                first_fill.append(landed - us[b, 1])
            n += 1
        n_items.append(n)
    ph = {k: _stats(np.array(v)) for k, v in items.items() if v}
    ph["setup (item list)"] = _stats(us[:, 1] - us[:, 0])
    if first_fill:
        ph["first ring fill"] = _stats(np.array(first_fill))
    ph["walk end to block end"] = _stats(us[:, 127] - us[:, 126])
    ph["block lifetime"] = _stats(us[:, 127] - us[:, 0])
    return dict(phases=ph, items_per_block=[int(min(n_items)), float(np.mean(n_items)),
                                            int(max(n_items))],
                starts=us[:, 0], ends=us[:, 127])


def trace_rows(torch, dev, g, flush, lib, new: bool) -> dict:
    from repro_torch.kernels.int8_matmul import int8_matmul_batched

    report = {}
    zeros = np.zeros(MAX_BLOCKS * SLOTS, dtype=np.uint64)
    for e, c, k, n in TRACE_ROWS:
        x = torch.randint(-127, 128, (e, c, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (e, n, k), generator=g, device=dev, dtype=torch.int8)
        dx = torch.rand(e, c, generator=g, device=dev) * 1e-2
        dw = torch.rand(e, n, generator=g, device=dev) * 1e-3
        for _ in range(3):
            int8_matmul_batched(x, w, dx, dw)
        torch.cuda.synchronize()
        if lib.gemm_trace_clear(zeros.ctypes.data, zeros.nbytes):
            raise RuntimeError("batched_gemm_trace: clearing the trace failed")
        flush.zero_()
        torch.cuda.synchronize()
        int8_matmul_batched(x, w, dx, dw)
        torch.cuda.synchronize()
        buf = np.zeros_like(zeros)
        if lib.gemm_trace_copy(buf.ctypes.data, buf.nbytes):
            raise RuntimeError("batched_gemm_trace: reading the trace failed")
        tr = buf.reshape(MAX_BLOCKS, SLOTS).astype(np.int64)
        blocks = int((tr[:, 0] > 0).sum())
        tr = tr[:blocks]
        t0 = tr[:, 0].min()
        us = np.where(tr > 0, (tr - t0) / 1e3, 0.0)
        row = read_new(tr, us, blocks) if new else read_old(tr, us)
        starts, ends = row.pop("starts"), row.pop("ends")
        row.update(blocks=blocks, span_us=float(ends.max()),
                   starts_us_deciles=[float(v) for v in np.percentile(starts, range(0, 101, 10))],
                   ends_us_deciles=[float(v) for v in np.percentile(ends, range(0, 101, 10))])
        label = f"{e},{c},{k},{n}"
        print(f"== ({label}): {blocks} blocks, span {row['span_us']:.2f} us", flush=True)
        for name, (med, p10, p90) in row["phases"].items():
            print(f"   {name:34s} median {med:7.2f}  p10 {p10:7.2f}  p90 {p90:7.2f} us")
        for key in ("blocks_per_sm", "items_per_block"):
            if key in row:
                print(f"   {key} (min, mean, max): {row[key]}")
        print("   blocks start (deciles, us):", " ".join(f"{v:.1f}" for v in row["starts_us_deciles"]))
        print("   blocks end (deciles, us):  ", " ".join(f"{v:.1f}" for v in row["ends_us_deciles"]))
        report[label] = row
        del x, w
    return report


def time_rows(torch, cs, dev, g, flush, fills: dict) -> dict:
    import inspect

    from repro_torch.kernels.int8_matmul import int8_matmul_batched, int8_matmul_batched_ref

    takes_rows = "rows" in inspect.signature(int8_matmul_batched).parameters
    ms = {}
    rows_at = TIME_ROWS + [(64, c, k, n) for c in sorted({int(c) for c in fills} - set(
        r[1] for r in TIME_ROWS)) for k, n in ((2048, 1408), (1408, 2048))]
    for e, c, k, n in sorted(rows_at, key=lambda r: r[1]):
        x = torch.randint(-127, 128, (e, c, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (e, n, k), generator=g, device=dev, dtype=torch.int8)
        dx = torch.rand(e, c, generator=g, device=dev) * 1e-2
        dw = torch.rand(e, n, generator=g, device=dev) * 1e-3
        xb = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
        wb = torch.randn(e, k, n, generator=g, device=dev).to(torch.bfloat16)
        cases = [("full", None)]
        if takes_rows:
            cases += [(f"fill {f['run']} p{f['q']}",
                       torch.tensor(f["fill"], dtype=torch.int32, device=dev))
                      for f in fills.get(str(c), [])]
        iters = 20 if c > 64 else 50
        for name, rows in cases:
            kw = {"rows": rows} if rows is not None else {}
            y = int8_matmul_batched(x, w, dx, dw, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, int8_matmul_batched_ref(x, w, dx, dw, **kw)):
                raise AssertionError(f"int8_matmul_batched ({e},{c},{k},{n}) {name} differs "
                                     "from its plain version")
            label = f"{e},{c},{k},{n} {name}"
            ms[label] = cs.time_ms(torch, lambda: int8_matmul_batched(x, w, dx, dw, **kw),
                                   iters, flush)
            live = "" if rows is None else f" live experts {int((rows > 0).sum())}/{e}"
            print(f"  {label:36s} {ms[label]:.4f} ms{live}", flush=True)
        ms[f"{e},{c},{k},{n} bmm bf16"] = cs.time_ms(torch, lambda: torch.bmm(xb, wb), iters,
                                                    flush)
        print(f"  {e},{c},{k},{n} bmm bf16{'':18s} {ms[f'{e},{c},{k},{n} bmm bf16']:.4f} ms",
              flush=True)
        del x, w, xb, wb
    return ms


def moe_step(torch, cs, dev, new: bool) -> tuple:
    """The MoE runs' fills and graph step windows (``--moe``); ``new``: the
    tree has the batched kernel of its own.  Returns (summary, fills
    {C: [{"run", "q", "fill"}]} at the 10th/50th/90th percentile of each
    run's live share)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.launch import serve
    from repro_torch.models import Model, moe
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    cfg = dataclasses.replace(get_config(cs.MOE_ARCH), num_layers=cs.MOE_LAYERS,
                              kv_cache_dtype="bf16")
    model = Model(cfg, device=dev)
    raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
    paged = dict(kv_layout="paged", kv_block_size=128)
    tree = dict(drafter="ngram-tree", tree_branches=cs.TREE)
    scfgs = {name: SpecConfig(gamma=cs.GAMMA, verifier="w8a8", **kw) for name, kw in (
        ("spec", dict(drafter="ngram")), ("tree", tree),
        ("paged", dict(drafter="ngram", **paged)), ("paged_tree", dict(**tree, **paged)))}
    prep = SpecEngine(model, scfgs["spec"]).prepare_params(raw)
    del raw
    prompts_np = task_prompts(serve.TASK, cs.PAGED_REQUESTS, cs.PROMPT, cfg.vocab_size)
    prompts = torch.as_tensor(prompts_np[:cs.B], device=dev, dtype=torch.int32)
    seen, run = {}, [None]

    def record(layer, args):
        x, c = args[0], layer.cfg
        r = moe.route(moe.router_logits(x.reshape(-1, x.shape[-1]), layer.router.w),
                      c.experts_per_token, c.num_experts, c.moe_capacity_factor)
        count = torch.bincount(r["eidx"].reshape(-1), minlength=c.num_experts)
        seen.setdefault((run[0], r["C"]), []).append(count.clamp(max=r["C"]).tolist())

    hooks = [m.register_forward_pre_hook(record) for m in prep.modules()
             if isinstance(m, moe.MoE)]
    with torch.inference_mode():
        for name, scfg in scfgs.items():
            run[0] = name
            eng = SpecEngine(model, scfg, graphs=False)
            if scfg.kv_layout == "paged":
                eng.generate_requests(prep, [GenerationRequest(p, cs.NEW, seed=i)
                                             for i, p in enumerate(prompts_np)])
            else:
                eng.generate(prep, prompts, cs.NEW)
            del eng
    for h in hooks:
        h.remove()
    summary, picked = {}, {}
    for (name, c), fills in sorted(seen.items()):
        f = np.array(fills)
        live = (f > 0).mean(axis=1)
        order = np.argsort(live, kind="stable")
        idx = {q: order[int(q / 100 * (len(order) - 1))] for q in (10, 50, 90)}
        at = picked.setdefault(str(c), [])
        for q, i in idx.items():       # a batch prefill is the same in spec and tree
            if all(d["fill"] != f[i].tolist() for d in at):
                at.append(dict(run=name, q=q, fill=f[i].tolist()))
        kept = float(f.sum() / (f.shape[1] * c * len(f)))
        summary[f"{name} C {c}"] = dict(
            samples=len(f), live_share_mean=float(live.mean()),
            live_share_p10_p50_p90=[float(live[i]) for i in idx.values()],
            kept_rows_share=kept)
        print(f"  MoE {name} fills at C {c}: {len(f)} layer passes, experts with a kept slot "
              f"{live.mean():.4f} (p10/p50/p90 {[round(float(live[i]), 4) for i in idx.values()]}"
              f"), rows kept {kept:.4f}", flush=True)
    # the graph step (tick) of each run; the batched kernel by name, an older
    # tree's only in the chain step (no other call there takes width 8)
    for name, scfg in scfgs.items():
        cs.KERNEL_SYMBOLS = {"int8_matmul_batched": (
            [("batched_swap_kernel",), ("batched_tiled_kernel",)] if new
            else [("int8_gemm_kernel<8, 1, true>",)] if name == "spec" else [])}
        eng = SpecEngine(model, scfg)
        w = (cs.tick_window(torch, eng, prep, cs.window_requests(prompts_np))
             if scfg.kv_layout == "paged" else cs.step_window(torch, eng, prep, prompts))
        del eng
        summary[f"{name} step"] = w
        print(f"  MoE {name} W8A8 graph step {w['step_ms']:.3f} ms, device busy "
              f"{w['device_busy_ms_per_step']} ms/step, launches/step "
              f"{w['launches_per_step']}, in the graph ms/launch "
              f"{w['in_graph_ms_per_launch']}", flush=True)
    return summary, picked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-trace", action="store_true", help="no phase trace")
    ap.add_argument("--no-time", action="store_true", help="no timed rows")
    ap.add_argument("--moe", action="store_true",
                    help="the MoE runs' fills (timed too) and graph steps")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("batched_gemm_trace: no CUDA card is visible", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    from repro_torch.kernels import ops

    ops.build()                        # the tree's kernels, one nvcc each, all together
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    new = (src / "repro_torch" / "csrc" / "int8_batched.cu").exists()
    moe, fills = {}, {}
    if args.moe:                       # first, on an empty card; its fills are timed below
        moe, fills = moe_step(torch, cs, dev, new)
        gc.collect()
        torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    # timed first, from the tree's own library; then the instrumented copy
    ms = {} if args.no_time else time_rows(torch, cs, dev, g, flush, fills)
    trace = {}
    if not args.no_trace:
        import repro_torch.kernels.int8_matmul as i8

        lib_name = "int8_batched" if new else "int8_matmul"
        own = ops._library(lib_name)
        lib, _ = build(lib_name, src)
        i8._FN = None                  # the older tree caches its entry point
        trace = trace_rows(torch, dev, g, flush, lib, new)
        ops._LIBS[lib_name] = own      # the rest runs the tree's own kernels
        i8._FN = None
    out = dict(label=args.label, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               trace=trace, ms=ms, moe=moe, fills=fills)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(dict(label=args.label, device=out["device"], nvidia_smi=smi, ms=ms,
                          moe_busy_ms={k.removesuffix(" step"): v["device_busy_ms_per_step"]
                                       for k, v in moe.items() if k.endswith(" step")})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
