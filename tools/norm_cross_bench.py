"""Time the fused norm (``norm_smooth_quant``) and the cross-attention read
(``flash_decode_cross``) of a tree of the port, alone and inside the
captured decode step.

    python3 tools/norm_cross_bench.py [--src DIR] [--label NAME] [--out FILE]
                                      [--flush write|read] [--no-steps]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one chip call can time two trees in turns (parent, change, change,
parent: one process each).  Kernel rows, each held to its plain version
first (the norm bit for bit, the cross read within FLASH_TOL), then timed
as ``chip_smoke.time_ms`` times them (CUDA events, L2 flushed before every
launch, median of 50; ``--flush read`` empties L2 by reading, so a timed
call finds no dirty lines to write back): ``norm_smooth_quant`` at the 7B's
attn_norm (24, 4096) with three readers and at M 4, 88, 176, 256, one
reader, stablelm's 5120 and vision's 8192, moonshot's prefill (4092,
2048); ``smooth_quant`` at (24, 4096) and (24, 12288); the cross read at
whisper's (4, 6, 12/12, 1500, 64) and vision's (4, 6, 64/8, 1600, 128),
beside F.scaled_dot_product_attention.  Then (unless ``--no-steps``) the
W8A8 ngram spec step of ``quasar-paper-7b`` and of ``whisper-small``
(chip_smoke's weights, prompts and batch, through CUDA graphs):
``chip_smoke.step_window``'s step ms, device busy ms per step, launches
and device kernels per step, and each kernel's device time per launch in
the graph (the norm's kernel by name in either tree; the cross read's
sliced body where the tree has one — before it, the cross read ran the
self-attention kernels and cannot be told apart by name).  Prints one
line per row and, last, a JSON object {label, device, nvidia_smi, flush,
ms, steps}; ``--out`` also writes it to a file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NORM_ROWS = [(24, 4096, 3), (4, 4096, 3), (88, 4096, 3), (176, 4096, 3), (256, 4096, 3),
             (24, 4096, 1), (24, 5120, 3), (24, 8192, 3), (4092, 2048, 3)]
QUANT_ROWS = [(24, 4096), (24, 12288)]
CROSS_ROWS = {"whisper": (4, 6, 12, 12, 1500, 64), "vision": (4, 6, 64, 8, 1600, 128)}
# chip_smoke.KERNEL_SYMBOLS, with the fused norm's kernel before its own body too
IN_GRAPH = {"norm_smooth_quant": [("norm_quant_kernel",), ("quant_rows_kernel", "true,")],
            "flash_decode_cross": [("flash_sliced_kernel", "false>")]}


def kernel_rows(torch, cs, dev, flush) -> dict:
    from repro_torch.kernels.flash_decode import flash_decode_cross, flash_decode_ref
    from repro_torch.kernels.smooth_quant import (norm_smooth_quant, norm_smooth_quant_ref,
                                                  smooth_quant, smooth_quant_ref)

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for m, d, n in NORM_ROWS:
        x = (torch.randn(m, d, generator=g, device=dev) * 3).to(torch.bfloat16)
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        sm = [torch.rand(d, generator=g, device=dev) * 7.875 + 0.125 for _ in range(n)]
        for (q, dx), (rq, rdx) in zip(norm_smooth_quant(x, scale, 1e-5, sm),
                                      norm_smooth_quant_ref(x, scale, 1e-5, sm)):
            if not (torch.equal(q, rq) and torch.equal(dx.view(torch.int32),
                                                       rdx.view(torch.int32))):
                raise AssertionError(f"norm_smooth_quant ({m}, {d}) x{n} is not bit-equal")
        ms[f"norm_smooth_quant {m},{d},{n}"] = cs.time_ms(
            torch, lambda: norm_smooth_quant(x, scale, 1e-5, sm), 50, flush)
    for m, k in QUANT_ROWS:
        x = (torch.randn(m, k, generator=g, device=dev) * 3).to(torch.bfloat16)
        s = torch.rand(k, generator=g, device=dev) * 7.875 + 0.125
        (q, dx), (rq, rdx) = smooth_quant(x, s), smooth_quant_ref(x, s)
        if not (torch.equal(q, rq) and torch.equal(dx.view(torch.int32), rdx.view(torch.int32))):
            raise AssertionError(f"smooth_quant ({m}, {k}) is not bit-equal")
        ms[f"smooth_quant {m},{k}"] = cs.time_ms(torch, lambda: smooth_quant(x, s), 50, flush)
    for name, (b, t, hq, hkv, sa, dh) in CROSS_ROWS.items():
        q = torch.randn(b, t, hq, dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        qpos = torch.full((b, t), sa - 1, dtype=torch.int32, device=dev)
        torch.testing.assert_close(flash_decode_cross(q, k, v).float(),
                                   flash_decode_ref(q, k, v, qpos).float(), **cs.FLASH_TOL)
        ms[f"cross {name}"] = cs.time_ms(torch, lambda: flash_decode_cross(q, k, v), 50, flush)
        ms[f"cross {name} sdpa"] = cs.time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True).transpose(1, 2), 50, flush)
    for name, t in ms.items():
        print(f"  {name:34s} {t:.4f} ms", flush=True)
    return ms


def step_rows(torch, cs, dev) -> dict:
    """chip_smoke.step_window of the W8A8 ngram spec step of the 7B and of
    whisper-small, through graphs."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    steps = {}
    for arch in (cs.ARCH, "whisper-small"):
        cfg = get_config(arch)
        model = Model(cfg, device=dev)
        raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
        scfg = SpecConfig(gamma=cs.GAMMA, drafter="ngram", verifier="w8a8")
        prep = SpecEngine(model, scfg).prepare_params(raw)
        del raw
        aux = None
        if cfg.num_audio_frames:
            aux = (torch.randn(cs.B, cfg.num_audio_frames, cfg.d_model,
                               generator=torch.Generator(device=dev).manual_seed(7),
                               device=dev) * 0.5).to(cfg.dtype)
        prompts = torch.as_tensor(task_prompts(serve.TASK, cs.B, cs.PROMPT, cfg.vocab_size),
                                  device=dev, dtype=torch.int32)
        w = cs.step_window(torch, SpecEngine(model, scfg), prep, prompts, aux_embeds=aux)
        steps[arch] = w
        print(f"  {arch} spec W8A8 graph step {w['step_ms']:.3f} ms, device busy "
              f"{w['device_busy_ms_per_step']} ms/step, kernels/step "
              f"{w['device_kernels_per_step']}, launches/step {w['launches_per_step']}, in the "
              f"graph ms/launch {w['in_graph_ms_per_launch']}", flush=True)
        del model, prep, aux
        gc.collect()
        torch.cuda.empty_cache()
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    ap.add_argument("--no-steps", action="store_true", help="the kernel rows alone")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("norm_cross_bench: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs

    cs.KERNEL_SYMBOLS = IN_GRAPH
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    if args.flush == "read":
        class ReadFlush:          # chip_smoke.time_ms calls flush.zero_()
            def zero_(self, buf=flush.view(torch.int32)):
                return buf.amax()
        flush = ReadFlush()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    ms = kernel_rows(torch, cs, dev, flush)
    del flush
    torch.cuda.empty_cache()
    steps = {} if args.no_steps else step_rows(torch, cs, dev)
    out = dict(label=args.label, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               flush=args.flush, ms=ms, steps=steps)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
