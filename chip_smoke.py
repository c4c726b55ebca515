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
5. Paged phase (the continuous-batching scheduler over the paged,
   prefix-shared KV cache).  Kernel part: the four ``flash_decode_paged``
   variants (chain/tree × bf16/int8 KV) at the 7B chain and (3,2,1,1) tree
   windows with block size 128, 16 and 24 (one that divides neither the
   32-key chunk nor the 128-key split), over shuffled block tables with a
   scratch tail: bit-equal to the contiguous kernel on the same logical
   content and within rtol 2^-7 / atol 1e-5 of the plain version, timed
   beside the plain version and the contiguous kernel (the yardstick: no
   PyTorch call takes a block table).  Path part, through
   ``serve.main([... "--kv-layout", "paged"])``: (a) W8A8 ngram γ 5 KV
   bf16, 12 requests of 1024 tokens through 8 slots, 64 new tokens; (b) the
   (3,2,1,1) tree with W4A8 and KV int8, same requests; (d) W8A8 KV int8
   and (e) the tree with W8A8 KV bf16, 4 requests each; and (c)
   ``generate_requests`` over the contiguous cache with (a)'s settings.
   Each gated on its paged kernel's launches, no ``bad`` row and 64 tokens
   per request; (a)'s tokens must equal (c)'s.  A prefix-sharing run (8
   requests sharing a 1024-token prompt plus 128 own tokens, sharing on
   and off), a torch.profiler window over paged ticks of (a), and the
   lossless gate on the reduced config: paged × {ngram, ngram-tree,
   pruned} × {W8A8, W4A8} × KV {bf16, int8} equal to the contiguous and
   solo tokens, plus one run whose pool is small enough that preemption
   and swap-in happen.
6. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

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
PAGED_REQUESTS = 12                # (a)-(c): 12 requests through the default 8 slots
PAGED_RUNS = {                     # paged run -> (serve flags, batch, paged kernel it must launch)
    "paged_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "ngram", *GAMMA_FLAGS,
                            "--kv-cache", "bf16"], PAGED_REQUESTS, "flash_decode_paged"),
    "paged_tree_w4a8_kv_int8": (["--verifier", "w4a8", *TREE_FLAGS, "--kv-cache", "int8"],
                                PAGED_REQUESTS, "flash_decode_paged_tree_int8"),
    "paged_w8a8_kv_int8": (["--verifier", "w8a8", "--drafter", "ngram", *GAMMA_FLAGS,
                            "--kv-cache", "int8"], B, "flash_decode_paged_int8"),
    "paged_tree_w8a8_kv_bf16": (["--verifier", "w8a8", *TREE_FLAGS, "--kv-cache", "bf16"],
                                B, "flash_decode_paged_tree"),
}
PAGED_BLOCKS = (128, 16, 24)       # block sizes of the paged kernel phase
SHARED_PROMPT, OWN_TAIL, SHARED_REQUESTS = 1024, 128, 8
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
    busy_ms, top = device_time(torch, prof)
    info = dict(verifier=verifier, drafter=drafter, kv_cache=kv, tree_branches=branches,
                steps=PROFILE_STEPS, wall_ms=wall_ms,
                step_ms=wall_ms / PROFILE_STEPS,
                device_busy_ms=busy_ms or None,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                top_kernels_ms=top)
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


def to_pages(torch, dev, bs: int, seed: int, tensors: dict):
    """The logical content of contiguous (B, S, ...) tensors in shuffled
    physical blocks of ``bs`` keys behind a (B, nb) block table whose last
    two logical blocks stay on the scratch block 0; the scratch block and
    three spare blocks hold junk.  Returns (table, pools)."""
    B, S = tensors["k"].shape[:2]
    used = -(-S // bs)
    nb, N = used + 2, 1 + B * used + 3
    g = torch.Generator().manual_seed(seed)
    bt = torch.zeros((B, nb), dtype=torch.int32)
    bt[:, :used] = (torch.randperm(N - 1, generator=g)[:B * used] + 1).view(B, used)
    bt = bt.to(dev)
    rows = bt[:, :used].reshape(-1).long()
    pools = {}
    for name, x in tensors.items():
        tail = tuple(x.shape[2:])
        junk = (torch.randn((N, bs) + tail, generator=g) * 3).to(x.dtype).to(dev)
        pad = torch.zeros((B, used * bs - S) + tail, dtype=x.dtype, device=dev)
        junk[rows] = torch.cat([x, pad], dim=1).reshape((B * used, bs) + tail)
        pools[name] = junk
    return bt, pools


def paged_kernel_phase(torch, dev, flush, cfg):
    """The four flash_decode_paged variants at the 7B chain (T = γ+1) and
    (3,2,1,1) tree windows, for each block size of PAGED_BLOCKS: bit-equal
    to the contiguous kernel on the same logical content, within FLASH_TOL
    of the plain version; timed beside both."""
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                                  flash_decode_paged_ref, visible)
    from repro_torch.models.attention import _quant_kv

    g = torch.Generator(device=dev).manual_seed(13)
    HQ, HKV, DH = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    results = {}
    for tree in (False, True):
        tables = TreeTemplate(TREE if tree else (1,) * GAMMA).on(dev)
        t = tables.depths.shape[0]
        s_len = -(-(PROMPT + NEW + t + 1) // 128) * 128         # transformer.init_cache
        win_start = torch.full((B,), PROMPT - 1 + 17, dtype=torch.int32, device=dev)
        qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
        masks = dict(tree_mask=tables.mask, win_start=win_start) if tree else {}
        bits = dict(tree_bits=tables.mask_bits) if tree else {}
        vis = visible(qpos, s_len, masks.get("tree_mask"), masks.get("win_start"))
        # each batch row reads its keys up to the window's last live slot once
        keys = int(vis.any(dim=1).flip(-1).int().argmax(-1).neg().add(s_len).sum())
        for int8 in (False, True):
            name = "flash_decode_paged" + "_tree" * tree + "_int8" * int8
            q = torch.randn(B, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
            kv = {n: torch.randn(B, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
                  for n in ("k", "v")}
            if int8:
                kv["k"], kv["k_scale"] = _quant_kv(kv["k"])
                kv["v"], kv["v_scale"] = _quant_kv(kv["v"])
            scales = {n: kv[n] for n in ("k_scale", "v_scale") if n in kv}
            contig = flash_decode(q, kv["k"], kv["v"], qpos, **scales, **masks, **bits)
            rows = []
            for bs in PAGED_BLOCKS:
                bt, pools = to_pages(torch, dev, bs, bs + 100 * tree + 10 * int8, kv)
                pscales = {n: pools[n] for n in scales}
                run = lambda: flash_decode_paged(q, pools["k"], pools["v"], bt, qpos,  # noqa: E731
                                                 **pscales, **masks, **bits)
                plain = lambda: flash_decode_paged_ref(  # noqa: E731
                    q, pools["k"], pools["v"], bt, qpos, pscales.get("k_scale"),
                    pscales.get("v_scale"), masks.get("tree_mask"), masks.get("win_start"))
                o, ro = run(), plain()
                torch.cuda.synchronize()
                if not torch.equal(o, contig):
                    raise AssertionError(f"{name} bs={bs}: not bit-equal to the contiguous "
                                         "kernel on the same logical content")
                if not torch.isfinite(o).all():
                    raise AssertionError(f"{name} bs={bs}: non-finite output")
                torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                           msg=lambda m: f"{name} bs={bs}: {m}")
                err = (o.float() - ro.float()).abs().max().item()
                kv_bytes = 2 * keys * HKV * DH * (1 if int8 else 2) + (8 * keys * HKV if int8
                                                                       else 0)
                nbytes = (2 * 2 * B * t * HQ * DH + kv_bytes + 4 * B * t + 4 * bt.numel()
                          + (4 * tables.mask_bits.numel() if tree else 0))
                bms, by = bound_ms(nbytes, 4 * HQ * int(vis.sum()) * DH, "bf16")
                row = dict(shape=[B, t, HQ, HKV, s_len, DH], block_size=bs,
                           table=list(bt.shape), max_abs_err=err, bound_ms=bms, bound_by=by,
                           **timed(torch, run, plain, None, 50, flush))
                row["yardstick_contiguous_ms"] = time_ms(
                    torch, lambda: flash_decode(q, kv["k"], kv["v"], qpos, **scales, **masks,
                                                **bits), 50, flush)
                rows.append(row)
                del pools
            results[name] = rows
    log("  flash_decode_paged == contiguous flash_decode, bit for bit, for every variant "
        f"and block size {PAGED_BLOCKS}")
    for name, rows in results.items():
        for r in rows:
            log(f"  {name:30s} bs={r['block_size']:<4d} ms={r['ms']:.4f} "
                f"contiguous_ms={r['yardstick_contiguous_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"host_ms={r['host_ms']:.4f} max_abs_err={r['max_abs_err']}")
    return results


def scheduled_info(torch, dev, sr) -> dict:
    """What a scheduled 7B run records (``serve.ScheduledResult``)."""
    g = sr.group_stats[0]
    return dict(tok_s=sr.tokens_per_s, L=sr.mean_accept_len, steps=g["steps"],
                max_request_steps=sr.steps, requests=len(sr.results), slots=g["slots"],
                new_tokens=sr.new_tokens, wall_s=sr.wall_s, mean_step_ms=1e3 * sr.step_s,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                kv_layout=g["kv_layout"], cache_gb=g["cache_bytes"] / 1e9,
                **{k: g[k] for k in ("pool_blocks", "block_size", "peak_blocks",
                                     "shared_blocks", "cow_forks") if k in g},
                bad_rows=sum(int(r.bad) for r in sr.results))


def check_scheduled(name: str, info: dict, sr, n_requests: int) -> None:
    if info["bad_rows"]:
        raise AssertionError(f"{name}: non-finite verifier logits in {info['bad_rows']} rows")
    if len(sr.results) != n_requests or any(r is None or r.tokens.size != NEW
                                            for r in sr.results):
        raise AssertionError(f"{name}: not every request finished with {NEW} new tokens")


def paged_path_phase(torch, dev):
    """The paged runs through the serve CLI (``--kv-layout paged``)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    runs = {}
    for name, (flags, batch, needed) in PAGED_RUNS.items():
        argv = ["--arch", ARCH, "--batch", str(batch), "--prompt-len", str(PROMPT),
                "--new-tokens", str(NEW), "--kv-layout", "paged", *flags]
        log(f"paged run {name}: serve {' '.join(argv)}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sr = serve.main(argv)
        torch.cuda.synchronize()
        info = scheduled_info(torch, dev, sr)
        info.update(run_s_incl_init=time.perf_counter() - t0, launches=ops.launch_counts())
        log(f"  {json.dumps(info)}")
        if info["launches"].get(needed, 0) <= 0:
            raise AssertionError(f"{name}: {needed} never launched on the path")
        check_scheduled(name, info, sr, batch)
        info["tokens"] = np.stack([r.tokens for r in sr.results])
        runs[name] = info
        del sr
    return runs


def scheduled_phase(torch, dev, paged_tokens):
    """One 7B W8A8 model (KV bf16) for (c), the contiguous scheduled run of
    (a)'s requests, whose tokens must equal (a)'s; the prefix-sharing pair;
    and a profiled window of paged ticks."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype="bf16")
    model = Model(cfg, device=dev)
    spec = SpecConfig(gamma=GAMMA, temperature=0.0, drafter="ngram", verifier="w8a8")
    params = SpecEngine(model, spec).prepare_params(
        model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED)))
    prompts = task_prompts(serve.TASK, PAGED_REQUESTS, PROMPT, cfg.vocab_size)
    reqs = [GenerationRequest(p, NEW, seed=i) for i, p in enumerate(prompts)]
    out = {}

    def scheduled(scfg, requests):
        eng = SpecEngine(model, scfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.generate_requests(params, requests)
        torch.cuda.synchronize()
        tkey = f"{eng.drafter.name}:{eng.verifier.name}"
        sr = serve.ScheduledResult(res, time.perf_counter() - t0, eng.group_stats,
                                   eng.telemetry.summary()[tkey]["step_s"]["mean"])
        info = scheduled_info(torch, dev, sr)
        info["launches"] = ops.launch_counts()
        return sr, info

    log("scheduled run contiguous_w8a8_kv_bf16 (c): generate_requests, 12 requests")
    sr, info = scheduled(spec, reqs)
    log(f"  {json.dumps(info)}")
    check_scheduled("contiguous_w8a8_kv_bf16", info, sr, PAGED_REQUESTS)
    if info["launches"].get("flash_decode", 0) <= 0:
        raise AssertionError("contiguous scheduled run: flash_decode never launched")
    toks = np.stack([r.tokens for r in sr.results])
    same = [bool(np.array_equal(a, b)) for a, b in zip(paged_tokens, toks)]
    if not all(same):
        raise AssertionError(f"paged (a) tokens differ from contiguous (c): {same}")
    log(f"  paged (a) tokens == contiguous (c) tokens for all {PAGED_REQUESTS} requests")
    out["contiguous_w8a8_kv_bf16"] = info

    # -- prefix sharing: 8 requests = one 1024-token prompt + 128 own tokens
    head = task_prompts(serve.TASK, 1, SHARED_PROMPT, cfg.vocab_size)[0]
    tails = task_prompts("humaneval", SHARED_REQUESTS, OWN_TAIL, cfg.vocab_size, seed=1)
    shared_reqs = [GenerationRequest(np.concatenate([head, tl]), NEW, seed=i)
                   for i, tl in enumerate(tails)]
    sharing = {}
    for on in (True, False):
        scfg = dataclasses.replace(spec, kv_layout="paged", kv_block_size=128,
                                   kv_prefix_sharing=on)
        sr, info = scheduled(scfg, shared_reqs)
        check_scheduled(f"prefix sharing {on}", info, sr, SHARED_REQUESTS)
        if info["launches"].get("flash_decode_paged", 0) <= 0:
            raise AssertionError("prefix-sharing run: flash_decode_paged never launched")
        info["tokens"] = np.stack([r.tokens for r in sr.results])
        sharing["on" if on else "off"] = info
        log(f"  prefix sharing {'on' if on else 'off'}: "
            f"{json.dumps({k: v for k, v in info.items() if k != 'tokens'})}")
    a, b = sharing["on"].pop("tokens"), sharing["off"].pop("tokens")
    diff = [int(np.nonzero(x != y)[0][0]) if (x != y).any() else None for x, y in zip(a, b)]
    sharing["tokens_equal"] = all(d is None for d in diff)
    sharing["first_difference_per_request"] = diff
    sharing["peak_blocks_ratio_off_on"] = (sharing["off"]["peak_blocks"]
                                           / sharing["on"]["peak_blocks"])
    if sharing["on"]["shared_blocks"] <= 0:
        raise AssertionError("prefix-sharing run shared no block")
    log(f"  shared_blocks {sharing['on']['shared_blocks']}, peak_blocks "
        f"{sharing['on']['peak_blocks']} on / {sharing['off']['peak_blocks']} off "
        f"(x{sharing['peak_blocks_ratio_off_on']:.2f}); tokens equal: "
        f"{sharing['tokens_equal']} (first difference per request: {diff})")
    out["prefix_sharing"] = sharing
    out["profile_paged_w8a8_kv_bf16"] = profile_paged(
        torch, dev, SpecEngine(model, dataclasses.replace(spec, kv_layout="paged")), params,
        reqs)
    return out


def profile_paged(torch, dev, engine, params, reqs):
    """Device busy share over PROFILE_STEPS scheduler ticks (block top-up,
    COW sweep, decode step, the tick's host read) of the paged run (a),
    after the first wave's admissions."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import Scheduler

    group = engine.serving_group(params, reqs)
    sched = Scheduler(reqs, group.stats["slots"])
    state = group.state
    with torch.inference_mode():
        for _ in range(2):                                   # admissions + warm-up
            state, _ = sched.tick(state, **group.hooks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                state, _ = sched.tick(state, **group.hooks)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, by_name = device_time(torch, prof)
    info = dict(run="paged_w8a8_kv_bf16", slots=group.stats["slots"], steps=PROFILE_STEPS,
                wall_ms=wall_ms, step_ms=wall_ms / PROFILE_STEPS,
                device_busy_ms=busy_ms or None,
                device_busy_ms_per_step=busy_ms / PROFILE_STEPS if busy_ms else None,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                top_kernels_ms=by_name)
    log(f"  paged profile: {json.dumps(info)}")
    return info


def device_time(torch, prof):
    """(device busy ms, top kernels [[name, ms]]) of a torch.profiler run:
    device-side events only — a host-side op such as aten::mul also carries
    its kernel's time, which would count twice."""
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda item: -item[1])[:12]
    return sum(by_name.values()), [[k[:90], v] for k, v in top]


def paged_lossless_gate(torch, dev):
    """The paged scheduled path on the reduced config (4 layers) on the
    card: per-request greedy tokens equal to the contiguous scheduled run
    and to serving each request alone, for ngram, ngram-tree (3,2,1,1) and
    pruned × W8A8, W4A8 × KV bf16, int8 (block 16, prefix sharing on);
    then a pool small enough that a better-keyed arrival preempts a running
    request to host memory and it resumes — tokens unchanged."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.core.paged_cache import blocks_for_tokens, request_demand_tokens
    from repro_torch.data import task_prompts
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest
    from repro_torch.serving.scheduler import Scheduler

    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv,
                                  num_layers=4)
        model = Model(cfg, device=dev)
        raw = model.init_params(torch.Generator(device=dev).manual_seed(1))
        prompts = task_prompts("gsm8k", 6, 64, cfg.vocab_size)
        reqs = [GenerationRequest(p[:40 + 4 * i], 20 + 3 * i, seed=i)
                for i, p in enumerate(prompts)]
        for verifier in ("w8a8", "w4a8"):
            params = SpecEngine(model, SpecConfig(verifier=verifier)).prepare_params(raw)
            for drafter in ("ngram", "ngram-tree", "pruned"):
                spec = SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier,
                                  pruned_retention=0.75,
                                  tree_branches=TREE if drafter == "ngram-tree" else None)
                contiguous = SpecEngine(model, spec)
                paged = SpecEngine(model, dataclasses.replace(spec, kv_layout="paged",
                                                              kv_block_size=16))
                got = {"contiguous": contiguous.generate_requests(params, reqs, batch_slots=2),
                       "paged": paged.generate_requests(params, reqs, batch_slots=2),
                       "solo": [contiguous.generate_requests(params, [r], batch_slots=1)[0]
                                for r in reqs]}
                for name, res in got.items():
                    if any(r.bad for r in res):
                        raise AssertionError(f"reduced {drafter} {verifier} kv {kv} {name}: "
                                             "non-finite logits")
                    for r, s in zip(res, got["solo"]):
                        if not np.array_equal(r.tokens, s.tokens):
                            raise AssertionError(f"reduced {drafter} {verifier} kv {kv}: "
                                                 f"{name} != solo on the card")
            log(f"  reduced smollm-135m (4 layers) {verifier} kv={kv}: paged == contiguous "
                "== solo for ngram, ngram-tree, pruned (6 requests, 2 slots, block 16)")

    # preemption and swap-in: a low-priority request fills the pool, then
    # two better-keyed requests arrive; the scheduler evicts it and resumes it
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), num_layers=4)
    model = Model(cfg, device=dev)
    spec = SpecConfig(gamma=GAMMA, drafter="ngram", verifier="w8a8")
    params = SpecEngine(model, spec).prepare_params(
        model.init_params(torch.Generator(device=dev).manual_seed(1)))
    rng = np.random.default_rng(17)
    pat = rng.integers(0, cfg.vocab_size, 6)
    reqs = [GenerationRequest(rng.integers(0, cfg.vocab_size, 40), 24, seed=1, priority=2),
            GenerationRequest(np.tile(pat, 4), 12, seed=2),
            GenerationRequest(np.concatenate([np.tile(pat, 4), pat[:3]]), 12, seed=3)]
    bs = 8
    demand = blocks_for_tokens(request_demand_tokens(40, 24, GAMMA), bs)
    eng = SpecEngine(model, dataclasses.replace(spec, kv_layout="paged", kv_block_size=bs,
                                                kv_pool_blocks=1 + demand + 1))
    group = eng.serving_group(params, reqs, batch_slots=2)
    sched, state = Scheduler([], 2), group.state
    with torch.inference_mode():
        sched.submit(reqs[0])
        for _ in range(2):
            state, _ = sched.tick(state, **group.hooks)
        sched.submit(reqs[1])
        sched.submit(reqs[2])
        while sched.busy:
            state, _ = sched.tick(state, **group.hooks)
            group.ctx.check_invariants()
    snap = group.ctx.snapshot()
    if not (sched.preemptions > 0 and snap["preemptions"] > 0 and snap["swap_out_blocks"] > 0
            and snap["swap_in_blocks"] > 0):
        raise AssertionError(f"no preemption and swap-in happened: {snap}")
    want = SpecEngine(model, spec).generate_requests(params, reqs, batch_slots=2)
    for i, w in enumerate(want):
        if not np.array_equal(sched.results[i].tokens, w.tokens):
            raise AssertionError(f"preempted run: request {i} tokens differ from the "
                                 "uninterrupted run")
    log(f"  reduced smollm-135m: preemption + swap-in exercised ({snap['preemptions']} "
        f"preemptions, {snap['swap_out_blocks']} blocks out, {snap['swap_in_blocks']} in); "
        "tokens == the uninterrupted run")
    return snap


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
    log("paged phase: kernels")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    kern.update(paged_kernel_phase(torch, dev, flush, get_config(ARCH)))
    del flush
    log("paged phase: 7B paged runs")
    paged_runs = paged_path_phase(torch, dev)
    sched = scheduled_phase(torch, dev, paged_runs["paged_w8a8_kv_bf16"]["tokens"])
    for run in paged_runs.values():
        del run["tokens"]
    runs.update(paged_runs)
    runs["contiguous_w8a8_kv_bf16"] = sched.pop("contiguous_w8a8_kv_bf16")
    p = sched["profile_paged_w8a8_kv_bf16"]
    if p["device_busy_ms"]:
        p["device_idle_share_unprofiled"] = 1 - p["device_busy_ms_per_step"] / \
            runs["paged_w8a8_kv_bf16"]["mean_step_ms"]
        log(f"  paged_w8a8_kv_bf16: device busy {p['device_busy_ms_per_step']:.2f} ms/step; "
            f"idle {p['device_idle_share']:.3f} under the profiler, "
            f"{p['device_idle_share_unprofiled']:.3f} of the unprofiled step")
    log("paged phase: lossless gate")
    preempt = paged_lossless_gate(torch, dev)

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
        **{name: ("src/repro_torch/csrc/flash_decode.cu",
                  "src/repro/kernels/flash_decode.py:273", run)
           for run, (_, _, name) in PAGED_RUNS.items()},
    }
    # the representative main-path shape of each kernel in the summary line
    pick = {"smooth_quant": 0, "int8_matmul": 2, "flash_decode": 0, "flash_decode_int8": 0,
            "int4_matmul": 2, "flash_decode_tree": 0, "flash_decode_tree_int8": 0,
            **{name: 0 for (_, _, name) in PAGED_RUNS.values()}}   # paged: bs 128
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
            **({"yardstick_contiguous_ms": row["yardstick_contiguous_ms"]}
               if "yardstick_contiguous_ms" in row else {}),
            launches_by_run={k: v["launches"].get(kname, 0) for k, v in runs.items()
                             if isinstance(v, dict)}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(device=name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             kernels=kern, runs=runs, profile=prof, prefix_sharing=sched["prefix_sharing"],
             profile_paged=sched["profile_paged_w8a8_kv_bf16"], preemption=preempt),
        indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
