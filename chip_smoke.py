"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card, the software, and ``nvidia-smi``'s name and power limit.
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together).
3. Kernel phase: calls each kernel's wrapper at the shapes the main path
   gives it, on seeded inputs, and holds it against its plain PyTorch
   version (smooth_quant bit-equal, int8_matmul and int4_matmul exact,
   flash_decode — chain and token-tree windows — within one bf16 rounding
   step: rtol 2^-7, atol 1e-5 — both accumulate in f32 and round once to
   bf16), and the tree variant with the chain template bit-equal to the
   chain variant.  Times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call (CUDA events, L2
   flushed before every launch, median of many), beside the least time the
   card could take; int4_matmul, which no PyTorch call computes, has
   int8_matmul at the same shape beside it as its yardstick.
4. Path phase: runs the port's serve CLI in process on ``quasar-paper-7b``
   with seeded random weights — batch 4, 1024-token prompts, 64 new tokens,
   greedy: the W8A8 verifier with the ngram drafter (γ 5) over a bf16 and
   an int8 KV cache and with the vanilla drafter; the W4A8 verifier with
   the ngram drafter; the (3,2,1,1) token tree with W8A8 (bf16 KV) and W4A8
   (int8 KV); and the pruned drafter (retention 0.75, γ 5) with W8A8.  Each
   run starts from zeroed launch counters; it fails unless every kernel of
   its path launched and no row tripped the non-finite-logits flag.  A
   torch.profiler window over a few decode steps of the spec W8A8 (both KV
   dtypes), spec W4A8 and tree W8A8 runs gives the device's busy and idle
   share and device time by kernel.  Then the repo's own lossless gate on
   the reduced config on the card: greedy tokens equal to vanilla's for
   ngram, ngram-tree (3,2,1,1), pruned and ChainTreeAdapter(ngram), with
   W8A8 and W4A8, KV bf16 and int8.
5. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, before the last line, on any failure — and at once when no
CUDA card is visible or the port's sources are not beside this script.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
B, GAMMA, PROMPT, NEW = 4, 5, 1024, 64
ARCH = "quasar-paper-7b"
FLASH_TOL = dict(rtol=2 ** -7, atol=1e-5)   # one bf16 rounding step
SDPA_TOL = 1e-2                    # the yardstick keeps bf16 intermediates; a sanity check
SLEEP_CYCLES = 4_000_000           # ~2 ms of device time at H100 clocks
PROFILE_STEPS = 6
TREE = (3, 2, 1, 1)                 # the token-tree template of the tree runs
TREE_FLAGS = ["--tree-branches", ",".join(map(str, TREE))]
GAMMA_FLAGS = ["--gamma", str(GAMMA)]
MAIN_PATH_RUNS = {                 # run name -> (serve flags, kernels it must launch)
    "spec_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "ngram", *GAMMA_FLAGS,
                           "--kv-cache", "bf16"],
                          ("smooth_quant", "int8_matmul", "flash_decode")),
    "spec_w8a8_kv_int8": (["--verifier", "w8a8", "--drafter", "ngram", *GAMMA_FLAGS,
                           "--kv-cache", "int8"],
                          ("smooth_quant", "int8_matmul", "flash_decode_int8")),
    "vanilla_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "vanilla", *GAMMA_FLAGS,
                              "--kv-cache", "bf16"],
                             ("smooth_quant", "int8_matmul", "flash_decode")),
    "spec_w4a8_kv_bf16": (["--verifier", "w4a8", "--drafter", "ngram", *GAMMA_FLAGS,
                           "--kv-cache", "bf16"],
                          ("smooth_quant", "int4_matmul", "flash_decode")),
    "tree_w8a8_kv_bf16": (["--verifier", "w8a8", *TREE_FLAGS, "--kv-cache", "bf16"],
                          ("smooth_quant", "int8_matmul", "flash_decode_tree")),
    "tree_w4a8_kv_int8": (["--verifier", "w4a8", *TREE_FLAGS, "--kv-cache", "int8"],
                          ("smooth_quant", "int4_matmul", "flash_decode_tree_int8")),
    "pruned_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "pruned",
                             "--pruned-retention", "0.75", *GAMMA_FLAGS,
                             "--kv-cache", "bf16"],
                            ("smooth_quant", "int8_matmul", "flash_decode")),
}
PROFILES = {                       # profiled run -> (verifier, drafter, kv, tree branches)
    "spec_w8a8_kv_bf16": ("w8a8", "ngram", "bf16", None),
    "spec_w8a8_kv_int8": ("w8a8", "ngram", "int8", None),
    "spec_w4a8_kv_bf16": ("w4a8", "ngram", "bf16", None),
    "tree_w8a8_kv_bf16": ("w8a8", "ngram-tree", "bf16", TREE),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, flush, host: list | None = None) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (the decode step streams far more than L2 holds, so the main
    path finds its operands cold).  A device-side sleep before each start
    event lets the host enqueue ``fn`` before the device reaches it, so the
    interval holds device work only; the host's enqueue time of each call
    is appended to ``host`` (ms)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        if host is not None:
            host.append(1e3 * (time.perf_counter() - t0))
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def timed(torch, kernel, plain, library, iters: int, flush) -> dict:
    host = []
    out = dict(ms=time_ms(torch, kernel, iters, flush, host),
               plain_ms=time_ms(torch, plain, max(5, iters // 4), flush),
               library_ms=time_ms(torch, library, iters, flush) if library else None)
    out["host_ms"] = statistics.median(host)
    return out


def kernel_phase(torch, dev, flush, cfg):
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref, visible
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_ref
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref
    from repro_torch.kernels.smooth_quant import smooth_quant, smooth_quant_ref
    from repro_torch.models.attention import _quant_kv

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)
    D, FF, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    HQ, HKV, DH = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M = B * (GAMMA + 1)
    S = -(-(PROMPT + NEW + GAMMA + 2) // 128) * 128      # transformer.init_cache
    results = {}

    # -- smooth_quant: decode (M, K) for K = d_model and d_ff; prefill rows --
    rows = []
    for m, k in ((M, D), (M, FF), (B * (PROMPT - 1), D)):
        x = (torch.randn(m, k, generator=g, device=dev) * 3).to(torch.bfloat16)
        s = torch.rand(k, generator=g, device=dev) * 7.875 + 0.125
        q, dx = smooth_quant(x, s)
        rq, rdx = smooth_quant_ref(x, s)
        torch.cuda.synchronize()
        if not (torch.equal(q, rq) and torch.equal(dx.view(torch.int32), rdx.view(torch.int32))):
            raise AssertionError(f"smooth_quant ({m},{k}) is not bit-equal to its plain version")
        nbytes, ops = m * k * 2 + k * 4 + m * k + m * 4, 3 * m * k
        bms, by = bound_ms(nbytes, ops, "bf16")
        rows.append(dict(shape=[m, k], max_abs_err=0.0, bound_ms=bms, bound_by=by,
                         **timed(torch, lambda: smooth_quant(x, s),
                                 lambda: smooth_quant_ref(x, s), None, 50, flush)))
    results["smooth_quant"] = rows

    # -- int8_matmul: q/o, k/v, gate/up, down, lm_head at decode; a prefill GEMM --
    rows = []
    for m, k, n in ((M, D, D), (M, D, HKV * DH), (M, D, FF), (M, FF, D), (M, D, V),
                    (B * (PROMPT - 1), D, FF)):
        xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        dx = torch.rand(m, generator=g, device=dev) * 1e-2
        dw = torch.rand(n, generator=g, device=dev) * 1e-3
        y = int8_matmul(xq, w, dx, dw)
        ry = int8_matmul_ref(xq, w, dx, dw)
        torch.cuda.synchronize()
        if not torch.equal(y, ry):
            raise AssertionError(f"int8_matmul ({m},{k},{n}) differs from its plain version")

        def library():
            acc = torch._int_mm(xq, w.t())
            return (acc.float() * dx[:, None] * dw[None, :]).to(torch.bfloat16)

        if not torch.equal(library(), ry):
            raise AssertionError("torch._int_mm yardstick disagrees with the plain version")
        nbytes, ops = m * k + n * k + 4 * (m + n) + 2 * m * n, 2 * m * n * k
        bms, by = bound_ms(nbytes, ops, "int8")
        iters = 20 if n == V or m > M else 50
        rows.append(dict(shape=[m, k, n], max_abs_err=0.0, bound_ms=bms, bound_by=by,
                         **timed(torch, lambda: int8_matmul(xq, w, dx, dw),
                                 lambda: int8_matmul_ref(xq, w, dx, dw), library, iters,
                                 flush)))
        del xq, w, y, ry
    results["int8_matmul"] = rows

    # -- flash_decode: the verify window (T = γ+1) and the vanilla one (T = 1) --
    for name, int8 in (("flash_decode", False), ("flash_decode_int8", True)):
        rows = []
        for t in (GAMMA + 1, 1):
            q = torch.randn(B, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
            k = torch.randn(B, S, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
            v = torch.randn(B, S, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
            qpos = (torch.arange(t, device=dev) + PROMPT - 1 + 17).expand(B, t)
            qpos = qpos.to(torch.int32).contiguous()
            kw = {}
            if int8:
                k, ks = _quant_kv(k)
                v, vs = _quant_kv(v)
                kw = dict(k_scale=ks, v_scale=vs)
            o = flash_decode(q, k, v, qpos, **kw)
            ro = flash_decode_ref(q, k, v, qpos, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            if not torch.isfinite(o).all():
                raise AssertionError(f"{name} T={t}: non-finite output")
            torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                       msg=lambda m: f"{name} T={t}: {m}")
            # the work this qpos needs: each batch row reads its slots up to
            # its window's last position; each query row scores (and sums
            # values over) the keys at or before its own position
            keys = int((qpos.amax(dim=1).long() + 1).clamp(max=S).sum())
            kv_bytes = 2 * keys * HKV * DH * (1 if int8 else 2) + (8 * keys * HKV if int8 else 0)
            nbytes = 2 * 2 * B * t * HQ * DH + kv_bytes + 4 * B * t
            scored = int((qpos.long() + 1).clamp(max=S).sum())
            bms, by = bound_ms(nbytes, 4 * HQ * scored * DH, "bf16")
            library = None
            if not int8:       # SDPA with a boolean mask; int8 K/V has no such call
                mask = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]

                def library():
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=mask, enable_gqa=True).transpose(1, 2)

                lib_err = (library().float() - ro.float()).abs().max().item()
                if lib_err > SDPA_TOL:
                    raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
            rows.append(dict(shape=[B, t, HQ, HKV, S, DH], max_abs_err=err, bound_ms=bms,
                             bound_by=by,
                             **timed(torch, lambda: flash_decode(q, k, v, qpos, **kw),
                                     lambda: flash_decode_ref(q, k, v, qpos, **kw), library,
                                     50, flush)))
        results[name] = rows

    # -- int4_matmul: the W4A8 linears at the chain (M = 24) and tree (M = 88)
    #    verify windows, and a prefill GEMM; int8_matmul beside it as yardstick --
    MT = B * TreeTemplate(TREE).num_nodes
    rows = []
    for m, k, n in ((M, D, D), (M, D, HKV * DH), (M, D, FF), (M, FF, D), (M, D, V),
                    (MT, D, FF), (MT, D, V), (B * (PROMPT - 1), D, FF)):
        xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w4 = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        dx = torch.rand(m, generator=g, device=dev) * 1e-2
        dw = torch.rand(n, generator=g, device=dev) * 1e-3
        y = int4_matmul(xq, w4, dx, dw)
        ry = int4_matmul_ref(xq, w4, dx, dw)
        torch.cuda.synchronize()
        if not torch.equal(y, ry):
            raise AssertionError(f"int4_matmul ({m},{k},{n}) differs from its plain version")
        nbytes, ops = m * k + n * k // 2 + 4 * (m + n) + 2 * m * n, 2 * m * n * k
        bms, by = bound_ms(nbytes, ops, "int8")
        iters = 20 if n == V or m > MT else 50
        # no PyTorch call computes a packed-int4 GEMM: library_ms stays null
        row = dict(shape=[m, k, n], max_abs_err=0.0, bound_ms=bms, bound_by=by,
                   **timed(torch, lambda: int4_matmul(xq, w4, dx, dw),
                           lambda: int4_matmul_ref(xq, w4, dx, dw), None, iters, flush))
        row["yardstick_int8_matmul_ms"] = time_ms(
            torch, lambda: int8_matmul(xq, w8, dx, dw), iters, flush)
        rows.append(row)
        del xq, w4, w8, y, ry
    results["int4_matmul"] = rows

    # -- tree flash_decode: the (3,2,1,1) window of the tree runs and the
    #    widest templates, bf16 and int8 KV; each at the cache length the
    #    main path allocates for it --
    for name, int8 in (("flash_decode_tree", False), ("flash_decode_tree_int8", True)):
        rows = []
        for branches in (TREE, (4, 4, 4), (64,)):
            tables = TreeTemplate(branches).on(dev)
            t = tables.depths.shape[0]
            s_len = -(-(PROMPT + NEW + t + 1) // 128) * 128
            q = torch.randn(B, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
            k = torch.randn(B, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
            v = torch.randn(B, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
            win_start = torch.full((B,), PROMPT - 1 + 17, dtype=torch.int32, device=dev)
            qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
            kw = dict(tree_mask=tables.mask, win_start=win_start)
            bits = tables.mask_bits
            if int8:
                k, ks = _quant_kv(k)
                v, vs = _quant_kv(v)
                kw.update(k_scale=ks, v_scale=vs)
            o = flash_decode(q, k, v, qpos, tree_bits=bits, **kw)
            ro = flash_decode_ref(q, k, v, qpos, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            if not torch.isfinite(o).all():
                raise AssertionError(f"{name} {branches}: non-finite output")
            torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                       msg=lambda mm: f"{name} {branches}: {mm}")
            # each batch row reads its slots up to its window's last slot;
            # each query row scores (and sums values over) the keys it sees
            vis = visible(qpos, s_len, tables.mask, win_start)          # (B, T, S)
            keys = int(vis.any(dim=1).flip(-1).int().argmax(-1).neg().add(s_len).sum())
            kv_bytes = 2 * keys * HKV * DH * (1 if int8 else 2) + (8 * keys * HKV if int8 else 0)
            nbytes = 2 * 2 * B * t * HQ * DH + kv_bytes + 4 * B * t + tables.mask_bits.numel() * 4
            bms, by = bound_ms(nbytes, 4 * HQ * int(vis.sum()) * DH, "bf16")
            library = None
            if not int8:       # SDPA with the materialised mask; int8 K/V has no such call
                mask = vis[:, None]

                def library():
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=mask, enable_gqa=True).transpose(1, 2)

                lib_err = (library().float() - ro.float()).abs().max().item()
                if lib_err > SDPA_TOL:
                    raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
            rows.append(dict(shape=[B, t, HQ, HKV, s_len, DH], branches=list(branches),
                             max_abs_err=err, bound_ms=bms, bound_by=by,
                             **timed(torch,
                                     lambda: flash_decode(q, k, v, qpos, tree_bits=bits, **kw),
                                     lambda: flash_decode_ref(q, k, v, qpos, **kw), library,
                                     50, flush)))
        results[name] = rows

    # -- the tree variant with the chain template gives the chain variant's bits --
    for int8 in (False, True):
        chain = TreeTemplate.chain(GAMMA).on(dev)
        q = torch.randn(B, GAMMA + 1, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
        qpos = (torch.arange(GAMMA + 1, device=dev) + PROMPT - 1 + 17).expand(B, GAMMA + 1)
        qpos = qpos.to(torch.int32).contiguous()
        kw = {}
        if int8:
            k, ks = _quant_kv(k)
            v, vs = _quant_kv(v)
            kw = dict(k_scale=ks, v_scale=vs)
        a = flash_decode(q, k, v, qpos, **kw)
        b = flash_decode(q, k, v, qpos, tree_mask=chain.mask, win_start=qpos[:, 0].contiguous(),
                         tree_bits=chain.mask_bits, **kw)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"tree flash_decode with the chain template (int8 KV "
                                 f"{int8}) is not bit-equal to the chain variant")
    log("  tree flash_decode with the chain template == chain flash_decode, bit for bit "
        "(bf16 and int8 KV)")
    for name, rows in results.items():
        for r in rows:
            extra = (f" int8_ms={r['yardstick_int8_matmul_ms']:.4f}"
                     if "yardstick_int8_matmul_ms" in r else "")
            log(f"  {name:22s} {str(r['shape']):32s} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) library_ms={r['library_ms']} "
                f"host_ms={r['host_ms']:.4f} max_abs_err={r['max_abs_err']}{extra}")
    return results


def path_phase(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    runs = {}
    for name, (flags, needed) in MAIN_PATH_RUNS.items():
        argv = ["--arch", ARCH, "--batch", str(B), "--prompt-len", str(PROMPT),
                "--new-tokens", str(NEW), *flags]
        log(f"path run {name}: serve {' '.join(argv)}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = serve.main(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        info = dict(tok_s=r.tokens_per_s, L=r.mean_accept_len, steps=r.steps,
                    new_tokens=r.new_tokens, decode_s=r.wall_s, prefill_s=r.prefill_s,
                    mean_step_ms=1e3 * r.wall_s / max(r.steps, 1),
                    run_s_incl_init_prefill=total_s,
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    launches=counts, bad_rows=int(r.bad.sum()))
        log(f"  {json.dumps(info)}")
        missing = [k for k in needed if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
        if info["bad_rows"]:
            raise AssertionError(f"{name}: non-finite verifier logits in {info['bad_rows']} rows")
        if r.new_tokens != B * NEW:
            raise AssertionError(f"{name}: {r.new_tokens} new tokens, expected {B * NEW}")
        info["tokens"] = r.tokens[:, PROMPT:PROMPT + NEW].cpu()
        runs[name] = info
        del r
    toks = {name: run.pop("tokens") for name, run in runs.items()}
    a, b = toks["spec_w8a8_kv_bf16"], toks["vanilla_w8a8_kv_bf16"]
    shared = (a == b).float().mean().item()
    prefix = [int((a[i] != b[i]).nonzero()[0]) if (a[i] != b[i]).any() else NEW
              for i in range(B)]
    log(f"  greedy tokens shared by spec and vanilla (kv bf16): {shared:.4f} "
        f"(common prefix per row: {prefix})")
    runs["spec_vs_vanilla_shared_tokens"] = shared
    runs["spec_vs_vanilla_common_prefix"] = prefix
    for name in ("tree_w8a8_kv_bf16", "pruned_w8a8_kv_bf16"):
        runs[f"{name}_vs_vanilla_shared_tokens"] = (toks[name] == b).float().mean().item()
        log(f"  greedy tokens shared by {name} and vanilla: "
            f"{runs[f'{name}_vs_vanilla_shared_tokens']:.4f}")
    return runs


def profile_phase(torch, dev, verifier: str, drafter: str, kv: str, branches=None):
    """Device busy share over a window of decode steps of a main-path run
    (``verifier`` × ``drafter``, KV cache ``kv``), from a torch.profiler
    trace: the sum of kernel times (one stream, so kernels do not overlap)
    over the window's wall time, and device time by kernel."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype=kv)
    model = Model(cfg, device=dev)
    engine = SpecEngine(model, SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier,
                                          tree_branches=branches))
    params = engine.prepare_params(
        model.init_params(torch.Generator(device=dev).manual_seed(0)))
    prompts = torch.as_tensor(task_prompts("gsm8k", B, PROMPT, cfg.vocab_size),
                              device=dev, dtype=torch.int32)
    buf = PROMPT + NEW + engine.drafter.gamma + 2
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)  # noqa: E731
    with torch.inference_mode():
        state = engine._init_state(params, prompts, full(PROMPT), full(PROMPT + NEW), buf,
                                   prng.row_generators(range(B), dev))
        for _ in range(2):                                   # warm-up steps
            state = engine._step(params, state)
            state["length"].cpu()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):                   # as SpecEngine._run steps
                state = engine._step(params, state)
                state["length"].cpu()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a host-side op such as
        # aten::mul also carries its kernel's time, which would count twice
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda item: -item[1])[:12]
    info = dict(verifier=verifier, drafter=drafter, kv_cache=kv, tree_branches=branches,
                steps=PROFILE_STEPS, wall_ms=wall_ms,
                step_ms=wall_ms / PROFILE_STEPS,
                device_busy_ms=busy_ms or None,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                top_kernels_ms=[[k[:90], v] for k, v in top])
    log(f"  {json.dumps(info)}")
    return info


def lossless_gate(torch, dev):
    """The repo's own gate on the card: greedy tokens of every drafter equal
    vanilla's on the reduced config (4 layers, so the pruned drafter keeps
    3), for each quantized verifier and KV-cache dtype; and the chain
    drafter run through the tree route gives the chain route's tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.core.drafters import ChainTreeAdapter
    from repro_torch.core.protocols import get_drafter
    from repro_torch.data import task_prompts
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv,
                                  num_layers=4)
        model = Model(cfg, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(1))
        prompts = torch.as_tensor(task_prompts("gsm8k", 4, 64, cfg.vocab_size), device=dev)
        for verifier in ("w8a8", "w4a8"):
            def spec(drafter, **kw):
                return SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier,
                                  pruned_retention=0.75, **kw)

            engines = {name: SpecEngine(model, scfg, drafter=d) for name, scfg, d in (
                ("vanilla", spec("vanilla"), None),
                ("ngram", spec("ngram"), None),
                ("ngram-tree", spec("ngram-tree", tree_branches=TREE), None),
                ("pruned", spec("pruned"), None),
                ("chain-tree(ngram)", spec("ngram"),
                 ChainTreeAdapter(get_drafter("ngram", spec("ngram")))))}
            toks = {}
            for name, engine in engines.items():
                r = engine.generate(params, prompts, 32)
                if bool(r.bad.any()):
                    raise AssertionError(f"reduced {verifier} kv {kv} {name}: non-finite logits")
                toks[name] = r.tokens[:, :64 + 32]
            for name in ("ngram", "ngram-tree", "pruned", "chain-tree(ngram)"):
                if not torch.equal(toks[name], toks["vanilla"]):
                    raise AssertionError(f"reduced config, {verifier} kv {kv}: {name} != "
                                         "vanilla on the card")
            log(f"  reduced smollm-135m (4 layers) {verifier} kv={kv}: ngram, ngram-tree "
                f"{TREE}, pruned and chain-tree(ngram) == vanilla (32 tokens x 4 rows)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(smi)

    t0 = time.perf_counter()
    reports = ops.build()
    log(f"build: {time.perf_counter() - t0:.1f}s for {sorted(reports) or 'cached libraries'}")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    log("kernel phase")
    from repro_torch.configs import get_config
    kern = kernel_phase(torch, dev, flush, get_config(ARCH))
    del flush
    log("path phase")
    runs = path_phase(torch, dev)
    log("profile phase")
    prof = {run: profile_phase(torch, dev, *spec) for run, spec in PROFILES.items()}
    for run, p in prof.items():
        # the profiler slows the host; against the unprofiled run's step time
        if p["device_busy_ms"]:
            step_ms = runs[run]["mean_step_ms"]
            p["device_idle_share_unprofiled"] = 1 - p["device_busy_ms"] / p["steps"] / step_ms
            log(f"  {run}: device busy {p['device_busy_ms'] / p['steps']:.2f} ms/step; idle "
                f"{p['device_idle_share']:.3f} under the profiler, "
                f"{p['device_idle_share_unprofiled']:.3f} of the unprofiled step")
    log("lossless gate")
    lossless_gate(torch, dev)

    meta = {
        "smooth_quant": ("src/repro_torch/csrc/smooth_quant.cu",
                         "src/repro/kernels/smooth_quant.py:24", "spec_w8a8_kv_bf16"),
        "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                        "src/repro/kernels/int8_matmul.py:26", "spec_w8a8_kv_bf16"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:117", "spec_w8a8_kv_bf16"),
        "flash_decode_int8": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:134", "spec_w8a8_kv_int8"),
        "int4_matmul": ("src/repro_torch/csrc/int4_matmul.cu",
                        "src/repro/kernels/int4_matmul.py:29", "spec_w4a8_kv_bf16"),
        "flash_decode_tree": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:125", "tree_w8a8_kv_bf16"),
        "flash_decode_tree_int8": ("src/repro_torch/csrc/flash_decode.cu",
                                   "src/repro/kernels/flash_decode.py:143",
                                   "tree_w4a8_kv_int8"),
    }
    # the representative main-path shape of each kernel in the summary line
    pick = {"smooth_quant": 0, "int8_matmul": 2, "flash_decode": 0, "flash_decode_int8": 0,
            "int4_matmul": 2, "flash_decode_tree": 0, "flash_decode_tree_int8": 0}
    kernels = []
    for kname, (source, replaces, run) in meta.items():
        row = kern[kname][pick[kname]]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=runs[run]["launches"].get(kname, 0),
            max_abs_err=max(r["max_abs_err"] for r in kern[kname]),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"], shape=row["shape"],
            host_ms=row["host_ms"],
            launches_by_run={k: v["launches"].get(kname, 0) for k, v in runs.items()
                             if isinstance(v, dict)}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(device=name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             kernels=kern, runs=runs, profile=prof), indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
