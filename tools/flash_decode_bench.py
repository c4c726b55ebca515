"""Time the port's ``flash_decode`` kernels at the 7B main-path shapes.

    python3 tools/flash_decode_bench.py [--src DIR] [--label NAME] [--out FILE] [--ring-only]
                                        [--flush write|read]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one chip call can time two trees in turns (parent, change, change,
parent: one process each, since a process holds one ``repro_torch``).
Uses ``chip_smoke.py``'s shapes, inputs and timing (CUDA events, L2 flushed
before every launch, median of 50): the chain window (T 6) and the vanilla
one (T 1), the (3,2,1,1), (4,4,4) and (64,) token trees, bf16 and int8 KV,
and the paged kernel (chain and (3,2,1,1), block sizes 128, 16, 24); the
ring read at chip_smoke's ring rows (the 7B's 4224-slot ring at T 6 and
T 1, B 1, a ring filled by a 1024-token prefill, dh 80 and 160; alone with
``--ring-only``); F.scaled_dot_product_attention with a boolean mask
beside the bf16 contiguous ones; with ``--profile``, the split and merge
passes' device time apart (torch.profiler, 10 launches); with ``--flush
read``, L2 is emptied by reading a buffer instead of zeroing it, so a
timed call finds L2 clean rather than full of dirty lines to write back.  Each kernel output is held to FLASH_TOL of its plain
version before it is timed.  Prints one line per variant and, last, a JSON
object {label, device, nvidia_smi, ms: {variant: ms}}; ``--out`` also
writes it to a file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also the split and merge passes' device time (torch.profiler)")
    ap.add_argument("--ring-only", action="store_true", help="the ring read's rows alone")
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("flash_decode_bench: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                                  flash_decode_ref, visible)
    from repro_torch.models.attention import _quant_kv

    dev = torch.device("cuda", 0)
    F = torch.nn.functional
    cfg = get_config(cs.ARCH)
    HQ, HKV, DH, B = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cs.B
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
    ms = {}

    def timed(name, run, ref, sdpa=None):
        o = run()
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), ref.float(), **cs.FLASH_TOL,
                                   msg=lambda m: f"{name}: {m}")
        ms[name] = cs.time_ms(torch, run, 50, flush)
        if args.profile:        # device time of the split and merge passes apart
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.zero_()
                    run()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                for part, keys in (("split", ("flash_split", "flash_sliced")),
                                   ("merge", ("flash_merge",))):
                    if any(k in e.key for k in keys) and e.self_device_time_total > 0:
                        ms[f"{name} {part}"] = e.self_device_time_total / 1e3 / 10
        if sdpa is not None:
            ms[name + " sdpa"] = cs.time_ms(torch, sdpa, 50, flush)
        print(f"  {name:40s} {ms[name]:.4f} ms"
              + (f"  sdpa {ms[name + ' sdpa']:.4f}" if sdpa is not None else "")
              + "".join(f"  {part} {ms[f'{name} {part}']:.4f}" for part in ("split", "merge")
                        if f"{name} {part}" in ms), flush=True)

    windows = [("chain T6", (1,) * cs.GAMMA), ("chain T1", None), ("tree 3,2,1,1", cs.TREE),
               ("tree 4,4,4", (4, 4, 4)), ("tree 64", (64,))] * (not args.ring_only)
    for label, branches in windows:
        tree = label.startswith("tree")
        t = 1 if branches is None else TreeTemplate(branches).num_nodes
        s_len = -(-(cs.PROMPT + cs.NEW + t + 1) // 128) * 128
        if not tree:
            s_len = -(-(cs.PROMPT + cs.NEW + cs.GAMMA + 2) // 128) * 128
        win_start = torch.full((B,), cs.PROMPT - 1 + 17, dtype=torch.int32, device=dev)
        if tree:
            tables = TreeTemplate(branches).on(dev)
            qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
            masks = dict(tree_mask=tables.mask, win_start=win_start)
            bits = dict(tree_bits=tables.mask_bits)
        else:
            qpos = (win_start[:, None] + torch.arange(t, device=dev)).to(torch.int32).contiguous()
            masks, bits = {}, {}
        vis = visible(qpos, s_len, masks.get("tree_mask"), masks.get("win_start"))
        for int8 in (False, True):
            q = torch.randn(B, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
            kv = {n: torch.randn(B, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
                  for n in ("k", "v")}
            if int8:
                kv["k"], kv["k_scale"] = _quant_kv(kv["k"])
                kv["v"], kv["v_scale"] = _quant_kv(kv["v"])
            sc = {n: kv[n] for n in ("k_scale", "v_scale") if n in kv}
            name = f"{label} {'int8' if int8 else 'bf16'}"
            ref = flash_decode_ref(q, kv["k"], kv["v"], qpos, **sc, **masks)
            sdpa = None
            if not int8:
                mask = vis[:, None]

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), kv["k"].transpose(1, 2), kv["v"].transpose(1, 2),
                        attn_mask=mask, enable_gqa=True).transpose(1, 2)

            timed(name, lambda: flash_decode(q, kv["k"], kv["v"], qpos, **sc, **masks, **bits),
                  ref, sdpa)
            if label in ("chain T6", "tree 3,2,1,1"):
                for bs in cs.PAGED_BLOCKS:
                    bt, pools = cs.to_pages(torch, dev, bs, bs, kv)
                    psc = {n: pools[n] for n in sc}
                    timed(f"{name} paged bs {bs}",
                          lambda: flash_decode_paged(q, pools["k"], pools["v"], bt, qpos, **psc,
                                                     **masks, **bits), ref)
                    del pools
    # the ring read (chip_smoke.ring_rows' rows): (label, B, T, config, prefill, int8 K/V)
    zamba, stablelm = get_config("zamba2-2.7b"), get_config("stablelm-12b")
    past = cs.RING_PROMPT + 100
    rings = [("ring T6", B, cs.GAMMA + 1, cfg, past, (False, True)),
             ("ring T1", B, 1, cfg, past, (False, True)),
             ("ring B1 T6", 1, cs.GAMMA + 1, cfg, past, (False, True)),
             ("ring partly T6", B, cs.GAMMA + 1, cfg, cs.RING_FILL, (False, True)),
             ("ring dh80 T6", B, cs.GAMMA + 1, zamba, past, (False,)),
             ("ring dh160 T6", B, cs.GAMMA + 1, stablelm, past, (False,))]
    for label, b, t, c, fill, kinds in rings:
        for int8 in kinds:
            q, k, v, qpos, kw = cs.ring_inputs(torch, dev, g, b, t, c.num_heads, c.num_kv_heads,
                                               c.head_dim, int8, fill)
            ref = flash_decode_ref(q, k, v, qpos, **kw)
            sdpa = None
            if not int8:
                mask = visible(qpos, k.shape[1], kpos=kw["kpos"], window=kw["window"])[:, None]

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=mask, enable_gqa=True).transpose(1, 2)

            timed(f"{label} {'int8' if int8 else 'bf16'}",
                  lambda: flash_decode(q, k, v, qpos, **kw), ref, sdpa)
            del q, k, v, kw
    out = dict(label=args.label, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               flush=args.flush, ms=ms)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
