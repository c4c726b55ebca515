"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card, the software, and ``nvidia-smi``'s name and power limit.
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together).
3. Kernel phase: calls each kernel's wrapper at the shapes the main path
   gives it, on seeded inputs, and holds it against its plain PyTorch
   version (smooth_quant and norm_smooth_quant bit-equal, int8_matmul and
   int4_matmul exact, flash_decode — chain and token-tree windows — within
   one bf16 rounding step: rtol 2^-7, atol 1e-5 — both accumulate in f32
   and round once to bf16), the tree variant with the chain template bit-equal to the
   chain variant, and a tree window's root rows bit-equal to a T = 1 chain
   query at the window's start ((3,2,1,1) and (4,4,4), bf16 and int8 KV).
   norm_smooth_quant (the RMSNorm fused with the quantization of each
   linear that reads it) runs at attn_norm's shape, three readers, at the
   vanilla, chain, paged chain, tree and paged tree windows' rows;
   int4_matmul at every W4A8 linear of the chain window, gate/up and
   lm_head at the tree window, and prefill.
   Times the kernel, the plain version and, where one
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
   its path launched (norm_smooth_quant included: every run is quantized)
   and no row tripped the non-finite-logits flag; the
   greedy tokens of the bf16-KV W8A8 spec, tree and pruned runs must equal
   the vanilla run's (every op of the verify forward is row-invariant).
   Every run's decode step goes through CUDA graphs (the engine's default).
   A step window of the spec W8A8 (both KV dtypes), spec W4A8 and tree W8A8
   runs (unprofiled steps, then a torch.profiler window) gives the
   unprofiled step, the device's busy ms per step, its idle share, device
   time by kernel and the kernel launches per step.
5. Graph phase: one 7B model, eager (``graphs=False``) against graphs in
   one process for spec W8A8, spec W4A8, tree (3,2,1,1) W8A8, pruned W8A8
   (``generate``, batch 4, 64 new tokens) and paged (a) (12 requests, 8
   slots): replay tokens must equal eager tokens bit for bit, with equal
   launches over the run and one program captured; the step (tick) windows
   of all but pruned give unprofiled step ms, device busy ms per step, idle
   share, capture ms and launches per step, which must be equal in both
   modes (65 norm_smooth_quant + 64 smooth_quant + 225 int8_matmul + 32
   flash_decode on the W8A8 chain step).  Then the repo's
   own lossless gate on the reduced config on the card: greedy tokens equal
   to vanilla's for ngram, ngram-tree (3,2,1,1), pruned and
   ChainTreeAdapter(ngram), with W8A8 and W4A8, KV bf16 and int8.
5b. Ring phase (:func:`ring_phase`, the sliding-window ring cache): on
   the graph phase's weights, ``quasar-paper-7b`` at full depth with
   ``long_500k``'s window of 4096 (rings of 4224 slots): the ring variant
   of ``flash_decode`` against its plain version (7B windows, bf16 and
   int8 KV, B 1, a partly filled ring, dh 80 and 160) beside SDPA; greedy
   ngram ≡ vanilla on 2 × 5120-token prompts, 384 new tokens, bf16 and
   W8A8 × KV bf16 and int8, through graphs; replay ≡ eager;
   ``generate_requests`` over rings (six prompts of 300-5120 tokens
   through three recycled slots, W8A8), ngram ≡ vanilla per request; the
   ring's logits against the windowed
   no-cache forward; the long_500k verify step as a graph beside its
   roofline bound.  ``--ring-only`` runs it alone.
6. Paged phase (the continuous-batching scheduler over the paged,
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
   and off), a tick window over (a)'s first wave, and the
   lossless gate on the reduced config: paged × {ngram, ngram-tree,
   pruned} × {W8A8, W4A8} × KV {bf16, int8} equal to the contiguous and
   solo tokens, plus one run whose pool is small enough that preemption
   and swap-in happen.
7. Server phase (the serving front-end, ``serving/server.py``):
   ``quasar-paper-7b`` at full width and depth, seeded random bf16 weights
   kept raw beside the prepared W8A8 ones (the bf16 fallback lane reads
   them), paged KV (bf16, block 128, prefix sharing on), 8 slots,
   gsm8k-preset 1024-token prompts, 64 new tokens, greedy.  (s1) A virtual-
   clock ``ServingLoop`` with the ngram-tree (3,2,1,1) primary and
   ``degrade_on_overload`` (both the tree and the chain lane run), 16
   requests with deadlines, three of them hopeless behind a lower priority
   (shed): streamed tokens == ``result().tokens`` == the same requests
   through ``generate_requests``; conservation, every block back, every
   kernel of the path launched (counts zeroed just before), every
   robustness counter 0, one program per lane.  (s2) A ``StreamingServer``
   on its thread: 16 requests on a Poisson stream at 8 requests/s (seed 0)
   consumed token by token on this thread; the same equalities; TTFT
   p50/p99, ITL p50, served tokens/s and the tick's step ms against
   ``generate_requests``' tick.  (s3) Chaos: a seeded ``FaultPlan`` over the
   step, nan_verify, quant_corrupt, alloc and submit seams: conservation,
   every block back, untouched requests == (s1)'s tokens, NaN trips and
   bf16-rescued rows > 0.  Also the guardrail snapshot's cost per step.
8. MoE phase (``models/moe.py``): ``moonshot-v1-16b-a3b`` at full width,
   40 of its 48 layers (its raw bf16 and prepared weights fill ~70 GB),
   seeded random bf16 weights from the serve CLI's seed, s = 1, the card
   near empty at its start.  Kernels, each against its plain version at
   the rows the MoE runs give it (vanilla, chain, paged chain, tree, a
   paged admission's prefill, the batch prefill; the paged tree too for the
   batched kernel): ``int8_matmul_batched`` (the W8A8 expert product,
   every expert in one launch) bit-equal at each C (1 to 480) for up/gate
   and down with every row kept, timed beside a bf16 ``torch.bmm``, and
   again at the fills the spec W8A8 run's routing gave (its decode and
   prefill passes at the median share of experts keeping a slot), each
   with two bounds: over the bytes and operations that fill needs and over
   every expert's; ``smooth_quant`` on o's
   rows and the dispatched (E·C, 2048) and (E·C, 1408) rows,
   ``norm_smooth_quant`` at d 2048 (3 readers and 1), ``int8_matmul`` at
   q/k/v/o and ``lm_head``, ``int4_matmul`` at the W4A8 run's, all exact;
   ``flash_decode`` chain and tree and ``flash_decode_paged`` chain (block
   128) at G = 1.  At the config's capacity factor 1.25, through graphs,
   gsm8k-preset 1024-token prompts, 64 new tokens, greedy: ``generate`` at
   batch 4 with spec W8A8 (ngram γ 5, KV bf16), vanilla W8A8, tree
   (3,2,1,1) W8A8 and spec W4A8 (the experts stay int8), and paged W8A8
   ``generate_requests`` (12 requests through 8 slots, block 128): each
   gated on finite logits and on launching ``int8_matmul_batched`` and its
   attention kernel, with a step (tick) window each, the dropped share of
   expert slots and, for spec and tree, the greedy tokens shared with
   vanilla (drops make a row depend on its batch, so they need not be
   equal); the W8A8 chain step's launches must be
   ``moe_launches_per_chain_step``'s.  Each run again eagerly, with forward
   hooks that count the dropped slots and the experts keeping a slot (per
   layer too; the graphs carry no counting): replay tokens == eager
   tokens, bit for bit.  The lossless gate on a dropless copy of the
   config (the same weights, capacity factor = 64 experts), W8A8, 256-token
   prompts: spec, tree and pruned == vanilla (batch 2), paged == contiguous
   (4 requests through 2 slots).
9. SSM phase (``models/ssm.py``, ``kernels/ssd_update.py``):
   ``zamba2-2.7b`` at 54 of 54 layers and ``mamba2-370m`` at 48 of 48,
   seeded random bf16 weights, s = 1, the card empty at its start.
   Kernels, each against its plain version at the SSM path's shapes:
   ``ssd_update`` (states bit-equal, y within rtol 1e-5 / atol 1e-4) at
   the chain and vanilla windows with every state kept and at the pruned
   draft's T = 1 without, for both models; chain ``flash_decode`` at
   zamba2's head size 80, bf16 and int8 K/V, beside SDPA;
   ``int8_matmul`` and ``int4_matmul`` (exact) at ``in_proj`` (N 10448 and
   4384), ``out_proj``, the shared block's linears and ``lm_head``;
   ``norm_smooth_quant`` with 1, 3 and 2 readers and ``smooth_quant`` (bit-
   equal).  Then through graphs, the 7B phases' prompts, batch and budget:
   zamba2 spec and vanilla W8A8, W4A8 and W8A8 over an int8 KV cache, pruned
   W8A8, contiguous ``generate_requests`` (8 equal-length requests, 4
   slots); mamba2 spec and vanilla W8A8.  Each run with its launches,
   ``step_traces`` (one program) and the share of its new tokens seen
   earlier in their row, and (but the W4A8 and int8-KV vanilla runs, there
   for the gates) a step (tick) window, then again eagerly: replay ≡ eager,
   tokens and launches.  Gated on finite logits,
   every kernel of its path launched, the W8A8 chain step's launches
   (``ssm_launches_per_chain_step``), greedy spec and pruned ≡ vanilla and
   the scheduled requests ≡ the spec run's rows.
10. Families phase (:func:`families_phase`): codeqwen1.5-7b, stablelm-12b,
    llama-3.2-vision-90b (20 of 100 layers) and whisper-small at full
    width, their kernels at their shapes, every run through graphs and
    again eagerly, spec ≡ vanilla.  Every step window (here and in the
    profile and graph phases) also gives the device kernels run per step
    and the device time per launch in the graph of the kernels in
    ``KERNEL_SYMBOLS`` (the fused norm, the cross read), printed beside
    their flushed kernel-phase times.
11. Train phase (:func:`train_phase`, ``repro_torch/train``): the
    gradients of ``ssd_update`` and of the cross read against their plain
    versions' (f32, within 1e-4 of each tensor's max) and a wrapper with no
    backward refusing a gradient; the kernels of smollm-135m's served path
    at its full-width shapes against their plain versions; smollm-135m and
    mamba2-370m trained at full width and depth through the train CLI
    (bf16 weights, f32 moments, remat, each step a CUDA graph) on the
    Markov corpus, the loss down at least 1 nat, a graph replay profiled;
    each saved as the reference's ``.npz`` and loaded back bit for bit, then
    served from the checkpoint by the serve CLI (W8A8, ngram against
    vanilla: equal tokens; the path's kernels launched), L beside the
    random init's.
12. Launch phase (:func:`launch_phase`, ``repro_torch/launch``): (a) the
    dry-run of every arch × shape on the meta device for one card and for
    four (bytes per card, fits one card, roofline terms; the sliding-window
    ``long_500k`` combos through their ring caches; 44 rows each, any
    exception a failure); (b) the 7B W8A8 ngram chain step (batch 4,
    1024-token prompts, 64 new tokens, through graphs): ``step_bound_ms``
    and what bounds it beside the step window's device-busy and graph step
    ms, and the dry-run's predicted resident bytes (raw + prepared weights
    + engine state) beside ``torch.cuda.max_memory_allocated()`` over the
    generate run, within 10%; (c) ``examples/torch/quickstart.py --full``
    (smollm-135m trained, calibrated, quantized, served): lossless, with
    the norm/quantize, ``int8_matmul`` and ``flash_decode`` kernels
    launched; (d) the serve CLI at 7B with ``--mode spec`` (its tokens
    those of ``--drafter ngram``), then ``--mode spec --task humaneval
    --attn-impl pallas``; (e) the quickstart's trained smollm saved in the
    loop and in the scan layout (``Model.to_scan``) and served from each
    through ``--ckpt``: equal tokens.  ``--launch-only`` runs it alone.
13. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Exits non-zero, before the last line, on any failure — and at once when no
CUDA card is visible or the port's sources are not beside this script.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

B, GAMMA, PROMPT, NEW = 4, 5, 1024, 64
ARCH = "quasar-paper-7b"
FLASH_TOL = dict(rtol=2 ** -7, atol=1e-5)   # one bf16 rounding step
SDPA_TOL = 1e-2                    # the yardstick keeps bf16 intermediates; a sanity check
SLEEP_CYCLES, SLEEP_MS = 4_000_000, 2.0   # ~2 ms of device time at H100 clocks
PROFILE_STEPS = 6
TREE = (3, 2, 1, 1)                 # the token-tree template of the tree runs
TREE_FLAGS = ["--tree-branches", ",".join(map(str, TREE))]
GAMMA_FLAGS = ["--gamma", str(GAMMA)]
MAIN_PATH_RUNS = {                 # run name -> (serve flags, kernels it must launch)
    "spec_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "ngram", *GAMMA_FLAGS,
                           "--kv-cache", "bf16"],
                          ("norm_smooth_quant", "smooth_quant", "int8_matmul", "flash_decode")),
    "spec_w8a8_kv_int8": (["--verifier", "w8a8", "--drafter", "ngram", *GAMMA_FLAGS,
                           "--kv-cache", "int8"],
                          ("norm_smooth_quant", "smooth_quant", "int8_matmul",
                           "flash_decode_int8")),
    "vanilla_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "vanilla", *GAMMA_FLAGS,
                              "--kv-cache", "bf16"],
                             ("norm_smooth_quant", "smooth_quant", "int8_matmul",
                              "flash_decode")),
    "spec_w4a8_kv_bf16": (["--verifier", "w4a8", "--drafter", "ngram", *GAMMA_FLAGS,
                           "--kv-cache", "bf16"],
                          ("norm_smooth_quant", "smooth_quant", "int4_matmul",
                           "flash_decode")),
    "tree_w8a8_kv_bf16": (["--verifier", "w8a8", *TREE_FLAGS, "--kv-cache", "bf16"],
                          ("norm_smooth_quant", "smooth_quant", "int8_matmul",
                           "flash_decode_tree")),
    "tree_w4a8_kv_int8": (["--verifier", "w4a8", *TREE_FLAGS, "--kv-cache", "int8"],
                          ("norm_smooth_quant", "smooth_quant", "int4_matmul",
                           "flash_decode_tree_int8")),
    "pruned_w8a8_kv_bf16": (["--verifier", "w8a8", "--drafter", "pruned",
                             "--pruned-retention", "0.75", *GAMMA_FLAGS,
                             "--kv-cache", "bf16"],
                            ("norm_smooth_quant", "smooth_quant", "int8_matmul",
                             "flash_decode")),
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
BUDGET = 256                       # new tokens a step window's rows may take
WINDOW_STEPS = 10                  # unprofiled steps of a step window
GRAPH_RUNS = {                     # graph run -> (verifier, drafter, kv layout, tree branches)
    "spec_w8a8_kv_bf16": ("w8a8", "ngram", "contiguous", None),
    "spec_w4a8_kv_bf16": ("w4a8", "ngram", "contiguous", None),
    "tree_w8a8_kv_bf16": ("w8a8", "ngram-tree", "contiguous", TREE),
    "pruned_w8a8_kv_bf16": ("w8a8", "pruned", "contiguous", None),
    "paged_w8a8_kv_bf16": ("w8a8", "ngram", "paged", None),
}
GRAPH_WINDOWS = ("spec_w8a8_kv_bf16", "spec_w4a8_kv_bf16", "tree_w8a8_kv_bf16",
                 "paged_w8a8_kv_bf16")
W8A8_CHAIN_LAUNCHES = {"norm_smooth_quant": 65, "smooth_quant": 64, "int8_matmul": 225,
                       "flash_decode": 32}
KERNEL_SYMBOLS = {                 # launch counter -> its device kernel: a name holding
    "norm_smooth_quant": [("norm_quant_kernel",)],             # every substring of one tuple
    "flash_decode_cross": [("flash_sliced_kernel", "false>")],
    "int8_matmul_batched": [("batched_swap_kernel",), ("batched_tiled_kernel",)],
}
SERVER_REQUESTS, SERVER_SLOTS = 16, 8
HOPELESS = (5, 9, 11)              # (s1): priority 1, a deadline no slot frees in time
SERVER_STEP_S = 0.02               # (s1), (s3): virtual seconds per decode step
SERVER_RATE = 8.0                  # (s2): Poisson arrivals per second
CHAOS = "step@40,nan_verify@7,quant_corrupt@20,alloc@12,submit@3"   # (s3), seed 0
SERVER_KERNELS = ("norm_smooth_quant", "smooth_quant", "int8_matmul", "flash_decode_paged",
                  "flash_decode_paged_tree")
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 40                    # of 48: the weights' reckoning in PERF.md §4
MOE_GATE_PROMPT, MOE_GATE_NEW = 256, 32   # the dropless gate (batch 2)
SSM_ARCHS = ("zamba2-2.7b", "mamba2-370m")   # the SSM phase, at full width and depth
FAMILY_ARCHS = ("codeqwen1.5-7b", "stablelm-12b", "llama-3.2-vision-90b", "whisper-small")
FAMILY_VISION_LAYERS = 20          # of 100: the weights' reckoning in PERF.md §4
FAMILY_TAGS = {"codeqwen1.5-7b": "codeqwen", "stablelm-12b": "stablelm",
               "llama-3.2-vision-90b": "vision", "whisper-small": "whisper"}
TRAIN_RUNS = {                     # the train phase, full configs: steps, batch, seq, peak lr,
    "smollm-135m": (400, 16, 256, 6e-3, 20),           # warm-up steps (PERF.md §4, §6)
    "mamba2-370m": (800, 32, 64, 1.5e-3, 50),
}
TRAIN_ALPHA = 0.97                 # lm_batches' chance of following the chain
TRAIN_LOG_EVERY, TRAIN_DROP = 25, 1.0   # the gate: last 10 losses' mean >= 1 nat under step 1's
TRAIN_PROMPT, TRAIN_NEW = 192, 64       # served prompts + new tokens fill the trained length
GRAD_RTOL = 1e-4                        # f32 gradients against the plain version's
LAUNCH_CARDS = (1, 4)              # (a): the dry-run's plan on one card and on four
MEM_TOL = 0.10                     # (b): predicted resident bytes against the peak
RING_WINDOW = 4096                 # the ring phase: shapes.shape_cfg's long_500k window
RING_B, RING_PROMPT, RING_NEW = 2, 5120, 384   # (b): the prefill wraps the 4224-slot ring
RING_LOGITS_TOL = 2 ** -4          # (d): bf16 ring vs no-cache logits, of the largest |logit|
RING_FILL = 1024                   # (a): the partly filled ring's prefill (of 4224 slots)
RING_REQUEST_LENS = (5120, 700, 2600, 4500, 300, 1500)   # (c2): prompts, some under the window
RING_REQUEST_SLOTS, RING_REQUEST_NEW = 3, 96             # (c2): rows recycled twice
QUICKSTART_NEEDS = (("norm_smooth_quant", "smooth_quant"), ("int8_matmul",),
                    ("flash_decode",))   # (c): one of each group must launch


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, kind: str):
    """The card's least time for the work (``repro_torch.launch.roofline``
    holds the H100's peaks)."""
    from repro_torch.launch.roofline import bound_ms as card_bound_ms

    return card_bound_ms(nbytes, ops, kind)


def time_ms(torch, fn, iters: int, flush, host: list | None = None) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (the decode step streams far more than L2 holds, so the main
    path finds its operands cold).  A device-side sleep before each start
    event lets the host enqueue ``fn`` before the device reaches it, so the
    interval holds device work only: ~2 ms before the first, and before
    each later one twice the host's enqueue time of a warm call (the
    device's lag behind the host then grows with every launch); the host's
    enqueue time of each call is appended to ``host`` (ms)."""
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        warm.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    later = int(SLEEP_CYCLES * min(1.0, 2 * max(warm[1:]) / SLEEP_MS))
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for i, (start, end) in enumerate(ev):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES if i == 0 else later)
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


def smooth_quant_rows(torch, dev, g, flush, shapes, **tag) -> list:
    """``smooth_quant`` at each (M, K) of ``shapes``: bit-equal to its plain
    version (codes and scales), timed beside it."""
    from repro_torch.kernels.smooth_quant import smooth_quant, smooth_quant_ref

    rows = []
    for m, k in shapes:
        x = (torch.randn(m, k, generator=g, device=dev) * 3).to(torch.bfloat16)
        s = torch.rand(k, generator=g, device=dev) * 7.875 + 0.125
        q, dx = smooth_quant(x, s)
        rq, rdx = smooth_quant_ref(x, s)
        torch.cuda.synchronize()
        if not (torch.equal(q, rq) and torch.equal(dx.view(torch.int32), rdx.view(torch.int32))):
            raise AssertionError(f"smooth_quant ({m},{k}) is not bit-equal to its plain version")
        nbytes, ops = m * k * 2 + k * 4 + m * k + m * 4, 3 * m * k
        bms, by = bound_ms(nbytes, ops, "f32")
        rows.append(dict(shape=[m, k], **tag, max_abs_err=0.0, bound_ms=bms, bound_by=by,
                         **timed(torch, lambda: smooth_quant(x, s),
                                 lambda: smooth_quant_ref(x, s), None, 50, flush)))
    return rows


def norm_smooth_quant_rows(torch, dev, g, flush, ms, d: int, readers: int, eps: float,
                           **tag) -> list:
    """``norm_smooth_quant`` (an RMSNorm of width ``d`` fused with the
    quantization of each of its ``readers`` linears) at each row count of
    ``ms``: bit-equal to the plain version (the kernel's sum order in
    elementwise f32 adds); no PyTorch call computes it."""
    from repro_torch.kernels.smooth_quant import norm_smooth_quant, norm_smooth_quant_ref

    rows = []
    for m in ms:
        x = (torch.randn(m, d, generator=g, device=dev) * 3).to(torch.bfloat16)
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        sm = [torch.rand(d, generator=g, device=dev) * 7.875 + 0.125 for _ in range(readers)]
        got = norm_smooth_quant(x, scale, eps, sm)
        want = norm_smooth_quant_ref(x, scale, eps, sm)
        torch.cuda.synchronize()
        for (q, dx), (rq, rdx) in zip(got, want):
            if not (torch.equal(q, rq) and torch.equal(dx.view(torch.int32),
                                                       rdx.view(torch.int32))):
                raise AssertionError(f"norm_smooth_quant ({m},{d}) x{readers} is not "
                                     "bit-equal to its plain version")
        # read x, scale and the smooth vectors once, write each reader's codes
        # and scales; ~4 f32 operations per element for the norm, 4 per reader
        nbytes = m * d * 2 + (1 + readers) * d * 4 + readers * (m * d + 4 * m)
        bms, by = bound_ms(nbytes, m * d * (4 + 4 * readers), "f32")
        rows.append(dict(shape=[m, d, readers], **tag, max_abs_err=0.0, bound_ms=bms,
                         bound_by=by,
                         **timed(torch, lambda: norm_smooth_quant(x, scale, eps, sm),
                                 lambda: norm_smooth_quant_ref(x, scale, eps, sm),
                                 None, 50, flush)))
    return rows


def int8_matmul_rows(torch, dev, g, flush, shapes, **tag) -> list:
    """``int8_matmul`` at each (M, K, N) of ``shapes``: exact against its
    plain version, timed beside it and ``torch._int_mm`` + the same
    epilogue (where M > 16 and N, K are multiples of 8: what ``_int_mm`` takes)."""
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    rows = []
    for m, k, n in shapes:
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

        if m <= 16 or n % 8 or k % 8:   # torch._int_mm: more than 16 rows, N and K by 8
            library = None
        elif not torch.equal(library(), ry):
            raise AssertionError("torch._int_mm yardstick disagrees with the plain version")
        nbytes, ops = m * k + n * k + 4 * (m + n) + 2 * m * n, 2 * m * n * k
        bms, by = bound_ms(nbytes, ops, "int8")
        iters = 20 if n > 65536 or m > 256 else 50       # lm_head, prefill: fewer
        rows.append(dict(shape=[m, k, n], **tag, max_abs_err=0.0, bound_ms=bms, bound_by=by,
                         **timed(torch, lambda: int8_matmul(xq, w, dx, dw),
                                 lambda: int8_matmul_ref(xq, w, dx, dw), library, iters,
                                 flush)))
        del xq, w, y, ry
    return rows


def int4_matmul_rows(torch, dev, g, flush, shapes, **tag) -> list:
    """``int4_matmul`` at each (M, K, N) of ``shapes``: exact against its
    plain version, timed beside it and beside ``int8_matmul`` at the same
    shape (its yardstick: no PyTorch call computes a packed-int4 GEMM)."""
    from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_ref
    from repro_torch.kernels.int8_matmul import int8_matmul

    rows = []
    for m, k, n in shapes:
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
        iters = 20 if n > 65536 or m > 256 else 50       # lm_head, prefill: fewer
        # no PyTorch call computes a packed-int4 GEMM: library_ms stays null
        row = dict(shape=[m, k, n], **tag, max_abs_err=0.0, bound_ms=bms, bound_by=by,
                   **timed(torch, lambda: int4_matmul(xq, w4, dx, dw),
                           lambda: int4_matmul_ref(xq, w4, dx, dw), None, iters, flush))
        row["yardstick_int8_matmul_ms"] = time_ms(
            torch, lambda: int8_matmul(xq, w8, dx, dw), iters, flush)
        rows.append(row)
        del xq, w4, w8, y, ry
    return rows


def flash_chain_rows(torch, dev, g, flush, hq: int, hkv: int, dh: int, s_len: int,
                     int8: bool, pos: int = PROMPT - 1 + 17, **tag) -> list:
    """Chain ``flash_decode`` (int8 K/V with ``int8``) at the verify window
    (T = γ+1) and the vanilla one (T = 1), its first query at ``pos``, over
    an ``s_len``-slot cache: within one bf16 rounding step of its plain
    version, timed beside it and (bf16 K/V) beside SDPA with a boolean
    mask."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.models.attention import _quant_kv

    F = torch.nn.functional
    name = "flash_decode" + "_int8" * int8
    rows = []
    for t in (GAMMA + 1, 1):
        q = torch.randn(B, t, hq, dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, s_len, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, s_len, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        qpos = (torch.arange(t, device=dev) + pos).expand(B, t)
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
            raise AssertionError(f"{name} dh {dh} T={t}: non-finite output")
        torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                   msg=lambda m: f"{name} dh {dh} T={t}: {m}")
        # the work this qpos needs: each batch row reads its slots up to
        # its window's last position; each query row scores (and sums
        # values over) the keys at or before its own position
        keys = int((qpos.amax(dim=1).long() + 1).clamp(max=s_len).sum())
        kv_bytes = 2 * keys * hkv * dh * (1 if int8 else 2) + (8 * keys * hkv if int8 else 0)
        nbytes = 2 * 2 * B * t * hq * dh + kv_bytes + 4 * B * t
        scored = int((qpos.long() + 1).clamp(max=s_len).sum())
        bms, by = bound_ms(nbytes, 4 * hq * scored * dh, "bf16")
        library = None
        if not int8:       # SDPA with a boolean mask; int8 K/V has no such call
            mask = (torch.arange(s_len, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]

            def library():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True).transpose(1, 2)

            lib_err = (library().float() - ro.float()).abs().max().item()
            if lib_err > SDPA_TOL:
                raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
        rows.append(dict(shape=[B, t, hq, hkv, s_len, dh], **tag, max_abs_err=err,
                         bound_ms=bms, bound_by=by,
                         **timed(torch, lambda: flash_decode(q, k, v, qpos, **kw),
                                 lambda: flash_decode_ref(q, k, v, qpos, **kw), library,
                                 50, flush)))
    return rows


def flash_tree_rows(torch, dev, g, flush, hq: int, hkv: int, dh: int, templates,
                    int8: bool, **tag) -> list:
    """Tree ``flash_decode`` (int8 K/V with ``int8``) for each token-tree
    template of ``templates``, each over the cache length the main path
    allocates for it: within one bf16 rounding step of its plain version,
    timed beside it and (bf16 K/V) beside SDPA with the materialised mask."""
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref, visible
    from repro_torch.models.attention import _quant_kv

    F = torch.nn.functional
    name = "flash_decode_tree" + "_int8" * int8
    rows = []
    for branches in templates:
        tables = TreeTemplate(branches).on(dev)
        t = tables.depths.shape[0]
        s_len = -(-(PROMPT + NEW + t + 1) // 128) * 128
        q = torch.randn(B, t, hq, dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, s_len, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, s_len, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
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
            raise AssertionError(f"{name} {branches} dh {dh}: non-finite output")
        torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                   msg=lambda mm: f"{name} {branches} dh {dh}: {mm}")
        # each batch row reads its slots up to its window's last slot;
        # each query row scores (and sums values over) the keys it sees
        vis = visible(qpos, s_len, tables.mask, win_start)          # (B, T, S)
        keys = int(vis.any(dim=1).flip(-1).int().argmax(-1).neg().add(s_len).sum())
        kv_bytes = 2 * keys * hkv * dh * (1 if int8 else 2) + (8 * keys * hkv if int8 else 0)
        nbytes = 2 * 2 * B * t * hq * dh + kv_bytes + 4 * B * t + tables.mask_bits.numel() * 4
        bms, by = bound_ms(nbytes, 4 * hq * int(vis.sum()) * dh, "bf16")
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
        rows.append(dict(shape=[B, t, hq, hkv, s_len, dh], branches=list(branches), **tag,
                         max_abs_err=err, bound_ms=bms, bound_by=by,
                         **timed(torch,
                                 lambda: flash_decode(q, k, v, qpos, tree_bits=bits, **kw),
                                 lambda: flash_decode_ref(q, k, v, qpos, **kw), library,
                                 50, flush)))
    return rows


def kernel_phase(torch, dev, flush, cfg):
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.attention import _quant_kv

    g = torch.Generator(device=dev).manual_seed(0)
    D, FF, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    HQ, HKV, DH = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M = B * (GAMMA + 1)
    MT = B * TreeTemplate(TREE).num_nodes
    S = -(-(PROMPT + NEW + GAMMA + 2) // 128) * 128      # transformer.init_cache
    results = {}

    # -- smooth_quant: decode (M, K) for K = d_model and d_ff; prefill rows --
    results["smooth_quant"] = smooth_quant_rows(torch, dev, g, flush,
                                                ((M, D), (M, FF), (B * (PROMPT - 1), D)))

    # -- norm_smooth_quant: attn_norm with its three readers (q/k/v) at the
    #    vanilla (4), chain (24), paged chain (48), tree (88) and paged tree
    #    (176) windows' rows --
    results["norm_smooth_quant"] = norm_smooth_quant_rows(
        torch, dev, g, flush, (B, M, 2 * M, MT, 2 * MT), D, 3, cfg.norm_eps)

    # -- int8_matmul: q/o, k/v, gate/up, down, lm_head at the chain window; a
    #    prefill GEMM; gate/up at the vanilla (M 4), paged chain (8 slots, 48),
    #    tree (88) and paged tree (176) windows; the tree's lm_head --
    results["int8_matmul"] = int8_matmul_rows(
        torch, dev, g, flush,
        ((M, D, D), (M, D, HKV * DH), (M, D, FF), (M, FF, D), (M, D, V),
         (B * (PROMPT - 1), D, FF), (B, D, FF), (2 * M, D, FF), (MT, D, FF),
         (2 * MT, D, FF), (MT, D, V)))

    # -- flash_decode: the verify window (T = γ+1) and the vanilla one (T = 1) --
    for name, int8 in (("flash_decode", False), ("flash_decode_int8", True)):
        results[name] = flash_chain_rows(torch, dev, g, flush, HQ, HKV, DH, S, int8)

    # -- int4_matmul: the W4A8 linears at the chain (M = 24) and tree (M = 88)
    #    verify windows, and a prefill GEMM; int8_matmul beside it as yardstick --
    results["int4_matmul"] = int4_matmul_rows(
        torch, dev, g, flush,
        ((M, D, D), (M, D, HKV * DH), (M, D, FF), (M, FF, D), (M, D, V), (MT, D, FF),
         (MT, D, V), (B * (PROMPT - 1), D, FF)))

    # -- tree flash_decode: the (3,2,1,1) window of the tree runs and the
    #    widest templates, bf16 and int8 KV; each at the cache length the
    #    main path allocates for it --
    for name, int8 in (("flash_decode_tree", False), ("flash_decode_tree_int8", True)):
        results[name] = flash_tree_rows(torch, dev, g, flush, HQ, HKV, DH,
                                        (TREE, (4, 4, 4), (64,)), int8)

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

    # -- a tree window's root rows give a T = 1 chain query's bits at
    #    qpos = win_start (the keys before the window by position, the root
    #    by the mask), for every query head, whichever tile and row block
    #    holds them --
    for branches in (TREE, (4, 4, 4)):
        tables = TreeTemplate(branches).on(dev)
        t = tables.depths.shape[0]
        s_len = -(-(PROMPT + NEW + t + 1) // 128) * 128
        win_start = torch.full((B,), PROMPT - 1 + 17, dtype=torch.int32, device=dev)
        qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
        for int8 in (False, True):
            q = torch.randn(B, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
            k = torch.randn(B, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
            v = torch.randn(B, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
            kw = {}
            if int8:
                k, ks = _quant_kv(k)
                v, vs = _quant_kv(v)
                kw = dict(k_scale=ks, v_scale=vs)
            tree = flash_decode(q, k, v, qpos, tree_mask=tables.mask, win_start=win_start,
                                tree_bits=tables.mask_bits, **kw)
            root = flash_decode(q[:, :1].contiguous(), k, v, win_start[:, None].contiguous(),
                                **kw)
            torch.cuda.synchronize()
            if not torch.equal(tree[:, :1], root):
                raise AssertionError(f"tree flash_decode {branches} (int8 KV {int8}): the root "
                                     "rows differ from the T = 1 chain query at win_start")
    log(f"  tree flash_decode root rows == T = 1 chain rows at win_start, bit for bit "
        f"({TREE} and (4, 4, 4), bf16 and int8 KV)")
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
    # greedy speculation is lossless and every op of the verify forward is
    # row-invariant on the card (window rows, batch rows, norms, GEMMs)
    for name in ("spec", "tree_w8a8_kv_bf16", "pruned_w8a8_kv_bf16"):
        if runs[f"{name}_vs_vanilla_shared_tokens"] != 1.0:
            raise AssertionError(f"7B greedy {name} tokens differ from vanilla's")
    return runs


def step_window(torch, engine, params, prompts, steps: int = WINDOW_STEPS,
                aux_embeds=None) -> dict:
    """Steps of one batch as ``SpecEngine._run`` takes them (each ends in the
    host read of the lengths), the rows' budget (BUDGET new tokens)
    outlasting the window: two warm-up steps (through graphs: the eager
    first step, then the capture and its first replay), ``steps`` timed on
    the host clock with no profiler (the unprofiled step, and beside it the
    process's CPU time per step), then PROFILE_STEPS under torch.profiler
    with the launch counters zeroed (device busy ms and launches per
    step).  ``engine`` may be any tree's ``SpecEngine`` (tools/step_bench.py
    passes another tree's); ``aux_embeds`` go to the prefill of a
    cross-attention model."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import prng
    from repro_torch.kernels import ops

    dev = prompts.device
    b, p = prompts.shape
    full = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)  # noqa: E731
    with torch.inference_mode():
        state = engine._init_state(params, prompts, full(p), full(p + BUDGET),
                                   p + BUDGET + engine.drafter.gamma + 2,
                                   prng.row_generators(range(b), dev),
                                   **({"aux_embeds": aux_embeds} if aux_embeds is not None
                                      else {}))
        for _ in range(2):
            state = engine._step(params, state)
            state["length"].cpu()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(steps):
            state = engine._step(params, state)
            state["length"].cpu()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        cpu_ms = 1e3 * (time.process_time() - c0) / steps
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                state = engine._step(params, state)
                state["length"].cpu()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v / PROFILE_STEPS for k, v in ops.launch_counts().items()}
    return window_info(torch, prof, step_ms, cpu_ms, wall_ms, launches)


def window_info(torch, prof, step_ms, cpu_ms, wall_ms, launches) -> dict:
    """A window's numbers; ``in_graph_ms_per_launch``: the device time of
    each KERNEL_SYMBOLS kernel that launched in the window over its
    launches, the kernel as the step runs it (its inputs just written, in
    L2) rather than after a flush."""
    busy_ms, top, by_name, kernels = device_time(torch, prof)
    busy = busy_ms / PROFILE_STEPS if busy_ms else None
    in_graph = {}
    for counter, names in KERNEL_SYMBOLS.items():
        n = launches.get(counter, 0) * PROFILE_STEPS
        ms = sum(v for k, v in by_name.items()
                 if any(all(p in k for p in parts) for parts in names))
        if n and ms:
            in_graph[counter] = ms / n
    return dict(step_ms=step_ms, cpu_ms=cpu_ms, profiled_step_ms=wall_ms / PROFILE_STEPS,
                device_busy_ms_per_step=busy,
                device_idle_share=(1 - busy / step_ms) if busy else None,
                device_idle_share_profiled=(1 - busy_ms / wall_ms) if busy_ms else None,
                launches_per_step=launches, top_kernels_ms=top,
                device_kernels_per_step=kernels / PROFILE_STEPS,
                in_graph_ms_per_launch=in_graph)


def profile_phase(torch, dev, verifier: str, drafter: str, kv: str, branches=None):
    """The step window (:func:`step_window`) of a main-path run
    (``verifier`` × ``drafter``, KV cache ``kv``) at 7B."""
    import dataclasses

    from repro_torch.configs import get_config
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
    info = dict(verifier=verifier, drafter=drafter, kv_cache=kv, tree_branches=branches,
                **step_window(torch, engine, params, prompts))
    log(f"  {json.dumps(info)}")
    return info


def seven_b(torch, dev) -> tuple:
    """The 7B (KV bf16) with the serve CLI's seeded weights: (model, raw
    bf16 params, {verifier: prepared params} for W8A8 and W4A8), shared by
    the graph and ring phases."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype="bf16")
    model = Model(cfg, device=dev)
    raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
    return model, raw, {v: SpecEngine(model, SpecConfig(verifier=v)).prepare_params(raw)
                        for v in ("w8a8", "w4a8")}


def graph_phase(torch, dev, model, prepared):
    """The decode step through CUDA graphs (the default) against the eager
    step (``graphs=False``) at 7B: :func:`seven_b`'s model and weights,
    prepared once per verifier.  For each GRAPH_RUNS entry,
    eager then graph in one process: ``generate`` (B rows, NEW tokens; paged:
    ``generate_requests`` over (a)'s 12 requests), whose tokens must be
    equal bit for bit, with equal launches over the run and one program
    captured; then, for GRAPH_WINDOWS, the step (tick) window, whose
    launches per step must be equal in both modes (and W8A8_CHAIN_LAUNCHES on
    the W8A8 chain step)."""
    import numpy as np

    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    cfg = model.cfg
    prompts_np = task_prompts(serve.TASK, PAGED_REQUESTS, PROMPT, cfg.vocab_size)
    prompts = torch.as_tensor(prompts_np[:B], device=dev, dtype=torch.int32)
    reqs = [GenerationRequest(p, NEW, seed=i) for i, p in enumerate(prompts_np)]
    out = {}
    for name, (verifier, drafter, layout, branches) in GRAPH_RUNS.items():
        scfg = SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier,
                          tree_branches=branches, pruned_retention=0.75, kv_layout=layout)
        params = prepared[verifier]
        modes, toks = {}, {}
        for graphs in (False, True):
            eng = SpecEngine(model, scfg, graphs=graphs)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            if layout == "paged":
                t0 = time.perf_counter()
                res = eng.generate_requests(params, reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                toks[graphs] = np.stack([r.tokens for r in res])
                info = dict(served_tok_s=sum(r.new_tokens for r in res) / wall, wall_s=wall,
                            steps=eng.group_stats[0]["steps"],
                            bad_rows=sum(int(r.bad) for r in res))
            else:
                r = eng.generate(params, prompts, NEW)
                toks[graphs] = r.tokens[:, PROMPT:PROMPT + NEW].cpu().numpy()
                info = dict(decode_tok_s=r.tokens_per_s, wall_s=r.wall_s, steps=r.steps,
                            L=r.mean_accept_len, bad_rows=int(r.bad.sum()))
            info.update(launches=ops.launch_counts(), capture_ms=1e3 * eng.capture_s,
                        step_traces=eng.step_traces, captures=eng._programs.captures)
            if name in GRAPH_WINDOWS:
                info["window"] = (tick_window(torch, eng, params, window_requests(prompts_np))
                                  if layout == "paged" else
                                  step_window(torch, eng, params, prompts))
                info["window"]["capture_ms"] = 1e3 * eng.capture_s - info["capture_ms"]
            modes["graph" if graphs else "eager"] = info
            log(f"  {name} {'graph' if graphs else 'eager'}: "
                f"{json.dumps({k: v for k, v in info.items() if k != 'launches'})}")
            del eng
        eager, graph = modes["eager"], modes["graph"]
        if not np.array_equal(toks[False], toks[True]):
            raise AssertionError(f"graph {name}: replay tokens differ from eager tokens")
        if eager["bad_rows"] or graph["bad_rows"]:
            raise AssertionError(f"graph {name}: non-finite verifier logits")
        if graph["launches"] != eager["launches"]:
            raise AssertionError(f"graph {name}: launches {graph['launches']} through graphs, "
                                 f"{eager['launches']} eager")
        if (graph["step_traces"], graph["captures"], eager["captures"]) != (1, 1, 0):
            raise AssertionError(f"graph {name}: {graph['step_traces']} programs, "
                                 f"{graph['captures']} captures")
        if "window" in graph:
            per_step = graph["window"]["launches_per_step"]
            if per_step != eager["window"]["launches_per_step"]:
                raise AssertionError(f"graph {name}: launches per replayed step {per_step}, "
                                     f"eager {eager['window']['launches_per_step']}")
            if name == "spec_w8a8_kv_bf16" and per_step != W8A8_CHAIN_LAUNCHES:
                raise AssertionError(f"W8A8 chain step launches {per_step}")
        log(f"  {name}: replay tokens == eager tokens, bit for bit; launches equal")
        out[name] = modes
    return out


def ring_inputs(torch, dev, g, b: int, t: int, hq: int, hkv: int, dh: int, int8: bool,
                past: int):
    """A RING_WINDOW-token window's ring of RING_WINDOW + 128 slots (int8
    K/V with ``int8``), filled as the model's writes leave it — a prefill of
    ``past`` tokens (past one wrap, the write keeps its last 4224 rows;
    under RING_WINDOW, the slots past it stay unwritten), then the query
    window's own rows — and a (b, t) query window at ``past``.  Returns
    (q, k, v, qpos, kw): ``flash_decode(q, k, v, qpos, **kw)`` reads it."""
    import types

    from repro_torch.models.attention import init_attn_cache, write_cache

    kvcfg = types.SimpleNamespace(num_kv_heads=hkv, head_dim=dh, dtype=torch.bfloat16,
                                  kv_cache_dtype="int8" if int8 else "bf16")
    cache = init_attn_cache(kvcfg, b, RING_WINDOW, dev, RING_WINDOW)
    for start, n in ((0, past), (past, t)):
        k, v = (torch.randn(b, n, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        pos = (start + torch.arange(n, device=dev, dtype=torch.int32)).expand(b, n)
        write_cache(cache, k, v, pos.contiguous())
    q = torch.randn(b, t, hq, dh, generator=g, device=dev).to(torch.bfloat16)
    qpos = (past + torch.arange(t, device=dev, dtype=torch.int32)).expand(b, t).contiguous()
    kw = dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
              kpos=cache["kpos"], window=RING_WINDOW)
    return q, cache["k"], cache["v"], qpos, kw


def ring_rows(torch, dev, g, flush, hq: int, hkv: int, dh: int, int8: bool,
              ts=(GAMMA + 1, 1), past: int = RING_PROMPT + 100, b: int = B, **tag) -> list:
    """The ring variant of ``flash_decode`` (int8 K/V with ``int8``) over
    :func:`ring_inputs`' ring at each T of ``ts``: within one bf16 rounding
    step of its plain version, timed beside it and (bf16 K/V) beside SDPA
    with a boolean mask; the bound counts the slots some query row sees."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref, visible

    F = torch.nn.functional
    name = "flash_decode_ring" + "_int8" * int8
    rows = []
    for t in ts:
        q, k, v, qpos, kw = ring_inputs(torch, dev, g, b, t, hq, hkv, dh, int8, past)
        S = k.shape[1]
        o = flash_decode(q, k, v, qpos, **kw)
        ro = flash_decode_ref(q, k, v, qpos, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name} dh {dh} T={t}: non-finite output")
        torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                   msg=lambda m: f"{name} dh {dh} T={t}: {m}")
        # the work this ring needs: K/V of the slots some query row of the
        # batch row sees, every slot's position, q in, out; each query row
        # scores (and sums values over) the keys it sees
        vis = visible(qpos, S, kpos=kw["kpos"], window=RING_WINDOW)         # (B, T, S)
        read = int(vis.any(dim=1).sum())
        kv_bytes = 2 * read * hkv * dh * (1 if int8 else 2) + (8 * read * hkv if int8 else 0)
        nbytes = 2 * 2 * b * t * hq * dh + kv_bytes + 4 * b * S + 4 * b * t
        bms, by = bound_ms(nbytes, 4 * hq * int(vis.sum()) * dh, "bf16")
        library = None
        if not int8:       # SDPA with a boolean mask; int8 K/V has no such call
            mask = vis[:, None]

            def library():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True).transpose(1, 2)

            lib_err = (library().float() - ro.float()).abs().max().item()
            if lib_err > SDPA_TOL:
                raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
        rows.append(dict(shape=[b, t, hq, hkv, S, dh], window=RING_WINDOW, qpos0=past, **tag,
                         max_abs_err=err, bound_ms=bms, bound_by=by, slots_read=read,
                         **timed(torch, lambda: flash_decode(q, k, v, qpos, **kw),
                                 lambda: flash_decode_ref(q, k, v, qpos, **kw), library,
                                 50, flush)))
        del k, v, kw
    return rows


def ring_requests(torch, dev, base, prepared) -> dict:
    """(c2) of :func:`ring_phase`: ``generate_requests`` over contiguous
    rings, W8A8 verifier, KV bf16, greedy: the prompts of
    RING_REQUEST_LENS (two wrap the ring, four are shorter than the window)
    through RING_REQUEST_SLOTS slots, so rows are recycled through
    ``transformer.reset_cache`` and fresh rings of unwritten slots reach the
    ring read; ngram's tokens must equal vanilla's for every request."""
    import dataclasses

    import numpy as np

    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model, transformer
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    t0 = time.perf_counter()
    cfg = dataclasses.replace(base, kv_cache_dtype="bf16")
    model, params = Model(cfg, device=dev), transformer.with_config(prepared, cfg)
    full = task_prompts(serve.TASK, len(RING_REQUEST_LENS), max(RING_REQUEST_LENS),
                        cfg.vocab_size)
    reqs = [GenerationRequest(p[:n], RING_REQUEST_NEW, seed=i)
            for i, (p, n) in enumerate(zip(full, RING_REQUEST_LENS))]
    out, toks = {}, {}
    for drafter in ("vanilla", "ngram"):
        eng = SpecEngine(model, SpecConfig(gamma=GAMMA, temperature=0.0, drafter=drafter,
                                           verifier="w8a8"))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        res = eng.generate_requests(params, reqs, batch_slots=RING_REQUEST_SLOTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        tel = eng.telemetry.summary()[f"{eng.drafter.name}:{eng.verifier.name}"]
        info = dict(requests=len(reqs), slots=RING_REQUEST_SLOTS, prompt_lens=RING_REQUEST_LENS,
                    new_tokens=sum(int(r.new_tokens) for r in res),
                    steps=eng.group_stats[0]["steps"],
                    L=float(np.mean([r.accept_len for r in res])),
                    mean_step_ms=1e3 * tel["step_s"]["mean"], wall_s=wall,
                    launches=ops.launch_counts(), bad_rows=sum(int(r.bad) for r in res))
        if info["bad_rows"] or any(r.new_tokens != RING_REQUEST_NEW for r in res):
            raise AssertionError(f"ring requests {drafter}: {info}")
        if info["launches"].get("flash_decode_ring", 0) <= 0:
            raise AssertionError(f"ring requests {drafter}: the ring read never launched")
        toks[drafter] = [np.asarray(r.tokens) for r in res]
        log(f"  ring requests {drafter}: {json.dumps(info)}")
        out[drafter] = info
        del eng, res
    same = [bool(np.array_equal(a, b)) for a, b in zip(toks["ngram"], toks["vanilla"])]
    if not all(same):
        raise AssertionError(f"ring requests: greedy ngram tokens differ from vanilla's: {same}")
    log(f"  ring requests: greedy ngram == vanilla for all {len(reqs)} requests "
        f"({RING_REQUEST_SLOTS} slots)")
    out["phase_s"] = time.perf_counter() - t0
    del params, model
    return out


def ring_phase(torch, dev, flush, raw, prepared) -> tuple:
    """The sliding-window ring cache at 7B: ``quasar-paper-7b`` at full width
    and depth with ``launch/shapes.shape_cfg(cfg, "long_500k")``'s window of
    RING_WINDOW tokens (rings of 4224 slots), on the graph phase's seeded
    weights (``raw`` bf16 and ``prepared`` W8A8, viewed under the windowed
    config: nothing new is initialised).  (a) The ring variant of
    ``flash_decode`` against its plain version at the 7B chain and vanilla
    windows, bf16 and int8 K/V, at B 1 and over a ring filled by a
    RING_FILL-token prefill (most chunks unwritten), and at head sizes 80
    (zamba2) and 160 (stablelm-12b).  (b) ``generate`` through graphs on
    RING_B prompts of RING_PROMPT tokens (the prefill of 5119 wraps the
    ring), RING_NEW new
    tokens, greedy: ngram ≡ vanilla for the bf16 and W8A8 verifiers over
    bf16 and int8 KV, each run launching every kernel of its path.  (c) The
    W8A8 bf16-KV spec run again eagerly: tokens and launches equal.  (c2)
    :func:`ring_requests`: ``generate_requests`` over contiguous rings.  (d)
    The last verify window's logits from the ring (bf16) against a no-cache
    forward of the whole sequence with the window mask, within
    RING_LOGITS_TOL of the logits' largest magnitude; the unwindowed
    forward must be further off.  (e) The long_500k step: a B 1 ring filled
    by one forward of 4223 tokens at 520064, then the W8A8 verify forward at
    positions 524287.. captured as a CUDA graph and timed beside
    ``roofline.step_bound_ms`` at that shape.  Returns (record, kernel
    rows, runs)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline, serve, shapes
    from repro_torch.models import Model, transformer
    from repro_torch.serving.engine import SpecEngine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = shapes.shape_cfg(raw.cfg, "long_500k")
    if base.sliding_window != RING_WINDOW or base.num_layers != get_config(ARCH).num_layers:
        raise AssertionError(f"ring phase config: {base.name} window {base.sliding_window}, "
                             f"{base.num_layers} layers")
    out, runs, toks = {}, {}, {}

    # (a) the ring read at the 7B windows, and at head sizes 80 and 160
    g = torch.Generator(device=dev).manual_seed(24)
    kern = {"flash_decode_ring" + "_int8" * int8:
            ring_rows(torch, dev, g, flush, base.num_heads, base.num_kv_heads, base.head_dim,
                      int8, arch=ARCH) for int8 in (False, True)}
    for arch in ("zamba2-2.7b", "stablelm-12b"):
        c = get_config(arch)
        kern["flash_decode_ring"] += ring_rows(torch, dev, g, flush, c.num_heads,
                                               c.num_kv_heads, c.head_dim, False,
                                               ts=(GAMMA + 1,), arch=arch)
    # B 1 (the long_500k read's shape), and a partly filled ring (a
    # RING_FILL-token prefill: most chunks hold unwritten slots)
    for int8 in (False, True):
        kern["flash_decode_ring" + "_int8" * int8] += ring_rows(
            torch, dev, g, flush, base.num_heads, base.num_kv_heads, base.head_dim, int8,
            ts=(GAMMA + 1,), b=1, arch=ARCH) + ring_rows(
            torch, dev, g, flush, base.num_heads, base.num_kv_heads, base.head_dim, int8,
            ts=(GAMMA + 1,), past=RING_FILL, arch=ARCH, fill="partly filled")
    for name, rows in kern.items():
        for r in rows:
            log(f"  {name:22s} {str(r['shape']):32s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']}")
    out["kernel_s"] = time.perf_counter() - t_phase

    # (b) lossless gates through graphs, (c) replay ≡ eager
    prompts = torch.as_tensor(task_prompts(serve.TASK, RING_B, RING_PROMPT, base.vocab_size),
                              device=dev, dtype=torch.int32)

    def generate_run(name, verifier, kv, drafter, graphs=True):
        t_run = time.perf_counter()
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        model = Model(cfg, device=dev)
        params = transformer.with_config(raw if verifier == "bf16" else prepared, cfg)
        eng = SpecEngine(model, SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier),
                         graphs=graphs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r = eng.generate(params, prompts, RING_NEW)
        torch.cuda.synchronize()
        info = dict(launches=ops.launch_counts(), tok_s=r.tokens_per_s, L=r.mean_accept_len,
                    steps=r.steps, new_tokens=r.new_tokens, decode_s=r.wall_s,
                    prefill_s=r.prefill_s,
                    mean_step_ms=1e3 * (r.wall_s - r.capture_s) / max(r.steps, 1),
                    capture_ms=1e3 * r.capture_s, step_traces=eng.step_traces,
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    bad_rows=int(r.bad.sum()))
        needed = ("flash_decode_ring" + "_int8" * (kv == "int8"),) + (
            ("norm_smooth_quant", "smooth_quant", "int8_matmul") if verifier == "w8a8" else ())
        missing = [k for k in needed if info["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
        if info["bad_rows"] or r.new_tokens != RING_B * RING_NEW or info["step_traces"] != 1:
            raise AssertionError(f"{name}: {info}")
        toks[name] = r.tokens[:, :RING_PROMPT + RING_NEW]
        info["run_s"] = time.perf_counter() - t_run
        log(f"  {name}: L={info['L']:.3f} steps={info['steps']} "
            f"step_ms={info['mean_step_ms']:.2f} prefill_s={info['prefill_s']:.2f} "
            f"launches={info['launches']} peak_gb={info['peak_mem_gb']:.1f} "
            f"run_s={info['run_s']:.1f}")
        runs[name] = info
        del eng, r

    for verifier in ("bf16", "w8a8"):
        for kv in ("bf16", "int8"):
            tag = f"{verifier}_kv_{kv}"
            generate_run(f"ring_vanilla_{tag}", verifier, kv, "vanilla")
            generate_run(f"ring_spec_{tag}", verifier, kv, "ngram")
            if not torch.equal(toks[f"ring_spec_{tag}"], toks[f"ring_vanilla_{tag}"]):
                share = (toks[f"ring_spec_{tag}"] == toks[f"ring_vanilla_{tag}"]).float()
                raise AssertionError(f"ring {tag}: greedy spec tokens differ from vanilla's "
                                     f"({share.mean().item():.4f} shared)")
            runs[f"ring_spec_{tag}"]["vs_vanilla_shared_tokens"] = 1.0
    log(f"  ring: greedy ngram == vanilla over {RING_NEW} tokens x {RING_B} rows for "
        "bf16 and W8A8 verifiers, KV bf16 and int8")
    generate_run("ring_spec_w8a8_kv_bf16_eager", "w8a8", "bf16", "ngram", graphs=False)
    eager = runs.pop("ring_spec_w8a8_kv_bf16_eager")
    if not torch.equal(toks.pop("ring_spec_w8a8_kv_bf16_eager"), toks["ring_spec_w8a8_kv_bf16"]) \
            or eager["launches"] != runs["ring_spec_w8a8_kv_bf16"]["launches"]:
        raise AssertionError("ring spec W8A8: eager tokens or launches differ from replayed")
    out["eager_spec_w8a8_kv_bf16"] = eager
    log("  ring: replay tokens == eager tokens, bit for bit; launches equal")
    out["requests"] = ring_requests(torch, dev, base, prepared)

    # (d) the last verify window's logits against the windowed no-cache forward
    cfg = dataclasses.replace(base, kv_cache_dtype="bf16")
    model, params = Model(cfg, device=dev), transformer.with_config(raw, cfg)
    seq = toks["ring_spec_bf16_kv_bf16"][:1]
    n = seq.shape[1]
    with torch.inference_mode():
        cache = model.prefill(params, model.init_cache(1, n + GAMMA + 2),
                              seq[:, :n - GAMMA - 1])
        start = torch.full((1,), n - GAMMA - 1, dtype=torch.int32, device=dev)
        ring, _ = model.verify_step(params, cache, seq[:, n - GAMMA - 1:], start)
        del cache
        want = model.forward(params, seq)[0][:, n - GAMMA - 1:].clone()
        free = dataclasses.replace(cfg, sliding_window=None)
        wide = Model(free, device=dev).forward(transformer.with_config(raw, free), seq)[0]
        wide = wide[:, n - GAMMA - 1:].clone()
    err, err_wide = ((ring - w).abs().max().item() for w in (want, wide))
    scale = want.abs().max().item()
    out["windowed_logits"] = dict(tokens=n, max_abs_err=err, unwindowed_max_abs_err=err_wide,
                                  logits_max_abs=scale, tol=RING_LOGITS_TOL * scale,
                                  argmax_equal=bool(torch.equal(ring.argmax(-1),
                                                                want.argmax(-1))))
    log(f"  ring: verify logits vs windowed forward {json.dumps(out['windowed_logits'])}")
    if not err <= RING_LOGITS_TOL * scale or not err_wide > 2 * err:
        raise AssertionError(f"ring: windowed logits {out['windowed_logits']}")
    del ring, want, wide, params, model

    # (e) the long_500k step: W8A8 verify at positions 524287.. over a B 1 ring
    ctx = shapes.SHAPES["long_500k"]["seq_len"]
    model, params = Model(cfg, device=dev), transformer.with_config(prepared, cfg)
    gen = torch.Generator(device=dev).manual_seed(25)
    with torch.inference_mode():
        cache = model.init_cache(1, ctx)
        S = cache["layers"][0]["k"].shape[1]
        fill = torch.randint(0, cfg.vocab_size, (1, S - 1), generator=gen, device=dev)
        params(fill, torch.full((1,), ctx - S, dtype=torch.int32, device=dev), cache=cache,
               read_cache=False, need_logits=False)
        win = torch.randint(0, cfg.vocab_size, (1, GAMMA + 1), generator=gen, device=dev)
        start = torch.full((1,), ctx - 1, dtype=torch.int32, device=dev)
        ops.reset_launch_counts()
        eager, _ = model.verify_step(params, cache, win, start)
        launches = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = model.verify_step(params, cache, win, start)
        graph.replay()
        torch.cuda.synchronize()
        if not (torch.isfinite(logits).all() and torch.equal(logits, eager)):
            raise AssertionError("long_500k step: replayed logits non-finite or not eager's")
        kpos = cache["layers"][0]["kpos"]
        step_ms = time_ms(torch, graph.replay, 20, flush)
    bound, by = roofline.step_bound_ms(cfg, "w8a8", "bf16", 1, ctx, GAMMA + 1)
    roof = roofline.step_counts(cfg, "w8a8", "bf16", 1, ctx, GAMMA + 1)
    out["long_500k_step"] = dict(
        context=ctx, ring_slots=S, positions=[ctx - 1, ctx - 1 + GAMMA],
        kpos_range=[int(kpos.min()), int(kpos.max())], verify_graph_ms=step_ms,
        step_bound_ms=bound, bound_by=by, bound_share=bound / step_ms,
        kv_gbytes=roof.kv_bytes / 1e9, gbytes=roof.bytes_accessed / 1e9,
        launches_per_step=launches)
    log(f"  ring: long_500k {json.dumps(out['long_500k_step'])}")
    if launches.get("flash_decode_ring", 0) != cfg.num_layers:
        raise AssertionError(f"long_500k step launches {launches}")
    del graph, logits, eager, cache, params, model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, kern, runs


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


def paged_rows(torch, dev, g, flush, cfg, b: int, tree: bool, int8: bool, blocks,
               **tag) -> list:
    """One ``flash_decode_paged`` variant at ``cfg``'s heads, ``b`` rows of
    the chain (T = γ+1) or (3,2,1,1) tree window, for each block size of
    ``blocks``: bit-equal to the contiguous kernel on the same logical
    content, within FLASH_TOL of the plain version; timed beside both."""
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                                  flash_decode_paged_ref, visible)
    from repro_torch.models.attention import _quant_kv

    HQ, HKV, DH = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    name = "flash_decode_paged" + "_tree" * tree + "_int8" * int8
    tables = TreeTemplate(TREE if tree else (1,) * GAMMA).on(dev)
    t = tables.depths.shape[0]
    s_len = -(-(PROMPT + NEW + t + 1) // 128) * 128         # transformer.init_cache
    win_start = torch.full((b,), PROMPT - 1 + 17, dtype=torch.int32, device=dev)
    qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
    masks = dict(tree_mask=tables.mask, win_start=win_start) if tree else {}
    bits = dict(tree_bits=tables.mask_bits) if tree else {}
    vis = visible(qpos, s_len, masks.get("tree_mask"), masks.get("win_start"))
    # each batch row reads its keys up to the window's last live slot once
    keys = int(vis.any(dim=1).flip(-1).int().argmax(-1).neg().add(s_len).sum())
    q = torch.randn(b, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
    kv = {n: torch.randn(b, s_len, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
          for n in ("k", "v")}
    if int8:
        kv["k"], kv["k_scale"] = _quant_kv(kv["k"])
        kv["v"], kv["v_scale"] = _quant_kv(kv["v"])
    scales = {n: kv[n] for n in ("k_scale", "v_scale") if n in kv}
    contig = flash_decode(q, kv["k"], kv["v"], qpos, **scales, **masks, **bits)
    rows = []
    for bs in blocks:
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
        kv_bytes = 2 * keys * HKV * DH * (1 if int8 else 2) + (8 * keys * HKV if int8 else 0)
        nbytes = (2 * 2 * b * t * HQ * DH + kv_bytes + 4 * b * t + 4 * bt.numel()
                  + (4 * tables.mask_bits.numel() if tree else 0))
        bms, by = bound_ms(nbytes, 4 * HQ * int(vis.sum()) * DH, "bf16")
        row = dict(shape=[b, t, HQ, HKV, s_len, DH], **tag, block_size=bs,
                   table=list(bt.shape), max_abs_err=err, bound_ms=bms, bound_by=by,
                   **timed(torch, run, plain, None, 50, flush))
        row["yardstick_contiguous_ms"] = time_ms(
            torch, lambda: flash_decode(q, kv["k"], kv["v"], qpos, **scales, **masks,
                                        **bits), 50, flush)
        rows.append(row)
        del pools
    return rows


def paged_kernel_phase(torch, dev, flush, cfg):
    """The four flash_decode_paged variants at the 7B chain (T = γ+1) and
    (3,2,1,1) tree windows, for each block size of PAGED_BLOCKS
    (:func:`paged_rows`)."""
    g = torch.Generator(device=dev).manual_seed(13)
    results = {}
    for tree in (False, True):
        for int8 in (False, True):
            name = "flash_decode_paged" + "_tree" * tree + "_int8" * int8
            results[name] = paged_rows(torch, dev, g, flush, cfg, B, tree, int8, PAGED_BLOCKS)
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
        missing = [k for k in (needed, "norm_smooth_quant")
                   if info["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
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
    out["profile_paged_w8a8_kv_bf16"] = p = tick_window(
        torch, SpecEngine(model, dataclasses.replace(spec, kv_layout="paged")), params,
        window_requests(prompts))
    log(f"  paged tick window: {json.dumps(p)}")
    return out


def window_requests(prompts):
    """(a)'s first 8 prompts (one wave of the default slots) with budgets
    that outlast a tick window."""
    from repro_torch.serving.request import GenerationRequest

    return [GenerationRequest(p, BUDGET, seed=i) for i, p in enumerate(prompts[:8])]


def tick_window(torch, engine, params, reqs, steps: int = WINDOW_STEPS) -> dict:
    """Scheduler ticks of a serving group over ``reqs`` (block top-up, COW
    sweep, decode step, the tick's host read): two ticks for the first
    wave's admissions and the capture, ``steps`` unprofiled ticks, then
    PROFILE_STEPS under torch.profiler (as :func:`step_window`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import Scheduler

    group = engine.serving_group(params, reqs)
    sched = Scheduler(reqs, group.stats["slots"])
    state = group.state
    with torch.inference_mode():
        for _ in range(2):
            state, _ = sched.tick(state, **group.hooks)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(steps):
            state, _ = sched.tick(state, **group.hooks)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        cpu_ms = 1e3 * (time.process_time() - c0) / steps
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                state, _ = sched.tick(state, **group.hooks)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v / PROFILE_STEPS for k, v in ops.launch_counts().items()}
    if sched.results:
        raise AssertionError("a request finished inside the tick window")
    info = dict(slots=group.stats["slots"],
                **window_info(torch, prof, step_ms, cpu_ms, wall_ms, launches))
    return info


def device_time(torch, prof):
    """(device busy ms, top kernels [[name, ms]], {name: ms}, kernels run)
    of a torch.profiler run: device-side events only — a host-side op such
    as aten::mul also carries its kernel's time, which would count twice;
    copies and fills (Memcpy, Memset) are not counted as kernels."""
    by_name, kernels = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
    top = sorted(by_name.items(), key=lambda item: -item[1])[:12]
    return sum(by_name.values()), [[k[:90], v] for k, v in top], by_name, kernels


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


def server_phase(torch, dev):
    """(s1)-(s3) of the module docstring; returns their records."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.request import GenerationRequest
    from repro_torch.serving.server import ServerConfig, ServingLoop, StreamingServer

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype="bf16")
    model = Model(cfg, device=dev)
    raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
    scfg = SpecConfig(temperature=0.0, drafter="ngram-tree", verifier="w8a8",
                      tree_branches=TREE, kv_layout="paged", kv_block_size=128,
                      kv_prefix_sharing=True)
    prompts = task_prompts(serve.TASK, SERVER_REQUESTS, PROMPT, cfg.vocab_size)
    server_cfg = dict(batch_slots=SERVER_SLOTS, max_prompt_len=PROMPT, max_new_tokens=NEW,
                      admission="edf", degrade_on_overload=True, overload_factor=1.5)

    def requests(deadlines: bool):
        return [GenerationRequest(p, NEW, seed=i,
                                  priority=1 if deadlines and i in HOPELESS else 0,
                                  deadline_s=(None if not deadlines else
                                              0.05 if i in HOPELESS else 60.0))
                for i, p in enumerate(prompts)]

    def drain(loop, clock, handles, max_polls=4000):
        polls = 0
        while loop.busy:
            before = loop.total_steps
            loop.poll()
            clock[0] += (loop.total_steps - before) * SERVER_STEP_S
            polls += 1
            if polls > max_polls:
                raise AssertionError("server loop did not drain")
        torch.cuda.synchronize()
        return handles

    def contained(name, loop):
        loop.metrics.check_conservation()
        for lane in loop._lanes.values():
            lane.sched.check_conservation()
            lane.ctx.pool.check_invariants()
            if lane.ctx.pool.unique_allocated:
                raise AssertionError(f"{name}: {lane.ctx.pool.unique_allocated} blocks "
                                     "never returned")

    def streamed(name, handles):
        for h in handles:
            if h.status == "done" and not np.array_equal(h.collected(), h.result(0.0).tokens):
                raise AssertionError(f"{name}: request {h.rid}'s stream != its result")

    def record_ticks(sink):
        """Keep every tick's step time (the scheduler's, up to its host read)
        that ``sink.on_decode_step`` gets, by drafter:verifier key."""
        ticks, hook = {}, sink.on_decode_step

        def on_decode_step(key, accepted, step_s):
            ticks.setdefault(key, []).append(step_s)
            hook(key, accepted, step_s)
        sink.on_decode_step = on_decode_step
        return ticks

    def steady(ticks):
        """Per lane: ms of the ticks after its first two (eager, capture)."""
        return {k: dict(ticks=len(v), ms_median=1e3 * statistics.median(v[2:]),
                        ms_mean=1e3 * statistics.fmean(v[2:]), first_two_ms=[1e3 * x
                                                                  for x in v[:2]])
                for k, v in ticks.items() if len(v) > 2}

    out = {}
    # one engine for all runs: it prepares the raw weights once and keeps both
    # (the server's lanes read the prepared ones, its bf16 fallback the raw)
    eng = SpecEngine(model, scfg)
    # -- reference tokens and tick: the same requests through generate_requests
    ref_ticks = record_ticks(eng.telemetry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = eng.generate_requests(raw, requests(False), batch_slots=SERVER_SLOTS)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    del eng.telemetry.on_decode_step          # the lanes below feed it too
    ref_tokens = [r.tokens for r in ref]
    out["generate_requests"] = dict(wall_s=ref_wall, ticks=steady(ref_ticks),
                                    served_tok_s=sum(r.new_tokens for r in ref) / ref_wall,
                                    steps=eng.group_stats[0]["steps"],
                                    capture_ms=1e3 * eng.capture_s)
    log(f"  generate_requests (reference for s1-s3): {json.dumps(out['generate_requests'])}")

    # -- (s1) virtual clock: tree + chain lanes, deadlines, shedding
    traces0, captures0 = eng.step_traces, eng._programs.captures
    clock = [0.0]
    loop = ServingLoop(eng, raw, ServerConfig(**server_cfg), clock=lambda: clock[0])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = drain(loop, clock, [loop.submit(r) for r in requests(True)])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    summary = loop.metrics.summary()
    contained("s1", loop)
    streamed("s1", handles)
    status = [h.status for h in handles]
    if [i for i, st in enumerate(status) if st == "shed"] != list(HOPELESS) or \
            status.count("done") != SERVER_REQUESTS - len(HOPELESS):
        raise AssertionError(f"s1: statuses {status}")
    for h, want in zip(handles, ref_tokens):
        if h.status == "done" and not np.array_equal(h.result(0.0).tokens, want):
            raise AssertionError(f"s1: request {h.rid} != generate_requests")
    missing = [k for k in SERVER_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"s1: kernels never launched on the server path: {missing}")
    if any(summary["robustness"].values()):
        raise AssertionError(f"s1: robustness events in a fault-free run: "
                             f"{summary['robustness']}")
    lanes = {lane.key: lane for lane in loop._lanes.values()}
    if sorted(lanes) != ["ngram-tree:w8a8", "ngram:w8a8"] or summary["counters"]["degraded"] < 1:
        raise AssertionError(f"s1: lanes {sorted(lanes)}, degraded "
                             f"{summary['counters']['degraded']}")
    traces = eng.step_traces - traces0 + loop._degraded_engine.step_traces
    captures = (eng._programs.captures - captures0
                + loop._degraded_engine._programs.captures)
    if (traces, captures) != (2, 2):
        raise AssertionError(f"s1: {traces} programs, {captures} captures (one per lane)")
    # the guardrail's pre-step snapshot: host and device time of one take
    # (time_ms: the host enqueues each take while the card sleeps, so the
    # events hold its copies' device time only)
    snap, state = lanes["ngram-tree:w8a8"].pre, lanes["ngram-tree:w8a8"].state
    host = []
    with torch.inference_mode():
        device_ms = time_ms(torch, lambda: snap.take(state), 50,
                            torch.empty(1 << 20, dtype=torch.int8, device=dev), host)
    snapshot = dict(host_us=1e3 * statistics.median(host), device_us=1e3 * device_ms,
                    bytes=snap.nbytes)
    out["s1"] = dict(wall_s=wall, ticks=loop.total_steps, launches=launches,
                     statuses=status, counters=summary["counters"],
                     latency_virtual_s=summary["latency"], program_traces=traces,
                     kv_cache=summary["kv_cache"], snapshot=snapshot,
                     acceptance={k: dict(steps=v["steps"], mean=v["accept_len"].get("mean"))
                                 for k, v in summary["acceptance"].items()})
    log(f"  s1: {json.dumps({k: v for k, v in out['s1'].items() if k != 'latency_virtual_s'})}")
    log(f"  s1: streamed == result == generate_requests for the {status.count('done')} served; "
        f"{len(HOPELESS)} shed; conservation; every block back; no robustness event")
    s1_tokens = {h.rid: h.result(0.0).tokens for h in handles if h.status == "done"}
    for lane in loop._lanes.values():
        lane.engine.forget_state(lane.state)
    del loop, handles, lanes, snap, state
    torch.cuda.empty_cache()

    # -- (s2) real clock: the threaded server, Poisson arrivals, caller-thread consumption
    capture0 = eng.capture_s
    gaps = np.random.default_rng(0).exponential(1.0 / SERVER_RATE, size=SERVER_REQUESTS)
    reqs = requests(False)
    srv = StreamingServer(eng, raw, ServerConfig(**server_cfg))
    srv_ticks = record_ticks(srv.metrics)
    t0 = time.perf_counter()
    with srv:
        handles = []
        for gap, r in zip(gaps, reqs):
            time.sleep(gap)
            handles.append(srv.submit(r))
        chunks = [list(h.tokens()) for h in handles]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    contained("s2", srv.loop)
    streamed("s2", handles)
    for h, c, want in zip(handles, chunks, ref_tokens):
        if h.status != "done" or not np.array_equal(np.concatenate(c), want):
            raise AssertionError(f"s2: request {h.rid} ({h.status}) != generate_requests")
    summary = srv.metrics.summary()
    if any(summary["robustness"].values()):
        raise AssertionError(f"s2: robustness events: {summary['robustness']}")
    lat = summary["latency"]
    ticks = steady(srv_ticks)
    out["s2"] = dict(wall_s=wall, served_tok_s=summary["counters"]["stream_tokens"] / wall,
                     ttft_ms_p50=1e3 * lat["ttft_s"]["p50"], ttft_ms_p99=1e3 * lat["ttft_s"]["p99"],
                     itl_ms_p50=1e3 * lat["itl_s"]["p50"], itl_ms_p99=1e3 * lat["itl_s"]["p99"],
                     queue_ms_p50=1e3 * lat["queue_s"]["p50"], ticks=ticks,
                     counters=summary["counters"],
                     capture_ms=1e3 * (eng.capture_s - capture0
                                       + srv.loop._degraded_engine.capture_s))
    log(f"  s2: {json.dumps(out['s2'])}")
    lane_ticks = ", ".join(f"{k} {v['ms_median']:.2f}" for k, v in ticks.items())
    ref_median = out["generate_requests"]["ticks"]["ngram-tree:w8a8"]["ms_median"]
    log(f"  s2: TTFT p50 {out['s2']['ttft_ms_p50']:.1f} ms, p99 {out['s2']['ttft_ms_p99']:.1f} ms; "
        f"ITL p50 {out['s2']['itl_ms_p50']:.2f} ms; served {out['s2']['served_tok_s']:.1f} tok/s; "
        f"tick ms (median after the capture) {lane_ticks} against generate_requests' "
        f"{ref_median:.2f}")
    for lane in srv.loop._lanes.values():
        lane.engine.forget_state(lane.state)
    del srv, handles
    torch.cuda.empty_cache()

    # -- (s3) chaos: seeded faults over every seam the loop owns
    traces0 = eng.step_traces
    plan = FaultPlan.parse(CHAOS, seed=0)
    clock = [0.0]
    loop = ServingLoop(eng, raw, ServerConfig(**server_cfg), clock=lambda: clock[0],
                       faults=plan)
    t0 = time.perf_counter()
    handles = drain(loop, clock, [loop.submit(r) for r in requests(True)])
    wall = time.perf_counter() - t0
    contained("s3", loop)
    streamed("s3", handles)
    summary = loop.metrics.summary()
    rb = summary["robustness"]
    untouched = [h.rid for h in handles if h.status == "done" and h.rid not in loop.affected]
    for rid in untouched:
        # (s1) served all but the shed, each equal to generate_requests
        twin = s1_tokens.get(rid, ref_tokens[rid])
        if not np.array_equal(handles[rid].result(0.0).tokens, twin):
            raise AssertionError(f"s3: untouched request {rid} != its fault-free twin")
    if not (rb["verify_nan_trips"] > 0 and rb["bf16_rescued_rows"] > 0):
        raise AssertionError(f"s3: the guardrail did not run: {rb}")
    out["s3"] = dict(wall_s=wall, plan=CHAOS, fired=plan.summary(), robustness=rb,
                     statuses=[h.status for h in handles], affected=sorted(loop.affected),
                     untouched_equal_to_s1=len(untouched), counters=summary["counters"],
                     program_traces=eng.step_traces - traces0
                     + loop._degraded_engine.step_traces)
    log(f"  s3: {json.dumps(out['s3'])}")
    log(f"  s3: conservation; every block back; {len(untouched)} untouched requests == s1; "
        f"{rb['verify_nan_trips']} NaN trips, {rb['bf16_rescued_rows']} bf16-rescued rows")
    del loop, handles, eng, raw
    torch.cuda.empty_cache()
    return out


def moe_rows(cfg) -> dict:
    """The rows ``n`` each regime of the MoE phase gives its kernels, and
    the capacity ``C`` (rows per expert) the dispatch gives them at the
    config's factor: vanilla (B), chain (B(γ+1)), paged chain (8 slots of
    γ+1), (3,2,1,1) tree, paged tree (8 slots of it: no MoE run takes it,
    the batched kernel is held there too), a paged admission's single-row
    prefill, and the batch prefill."""
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.models.moe import capacity
    from repro_torch.serving.engine import DEFAULT_BATCH_SLOTS as SLOTS

    nodes = TreeTemplate(TREE).num_nodes
    rows = dict(vanilla=B, chain=B * (GAMMA + 1), paged=SLOTS * (GAMMA + 1), tree=B * nodes,
                paged_tree=SLOTS * nodes, admission=PROMPT - 1, prefill=B * (PROMPT - 1))
    return {k: (n, capacity(n, cfg.num_experts, cfg.experts_per_token,
                            cfg.moe_capacity_factor)) for k, n in rows.items()}


def batched_bounds(fill, c: int, k: int, n: int) -> dict:
    """The batched product's bounds at the per-expert kept rows ``fill``
    (E,): ``bound_ms``/``bound_by`` over the bytes the function must move
    at that fill (the W and scales of each expert that keeps a slot, the
    kept rows of X and their scales, Y written whole: the kernel zeroes
    the rest) and the kept rows' operations; ``bound_every_expert_ms``/
    ``_by`` over every expert's W, X and scales and every row's operations
    (the product with no ``rows``); the experts keeping a slot and the kept
    rows."""
    E, kept = fill.shape[0], int(fill.sum())
    live = int((fill > 0).sum())
    lms, lby = bound_ms(live * (n * k + 4 * n) + kept * (k + 4) + E * 2 * c * n,
                        2 * kept * n * k, "int8")
    bms, by = bound_ms(E * (c * k + n * k + 4 * (c + n) + 2 * c * n), 2 * E * c * n * k,
                       "int8")
    return dict(bound_ms=lms, bound_by=lby, bound_every_expert_ms=bms,
                bound_every_expert_by=by, live_experts=live, kept_rows=kept)


def batched_fill_rows(torch, dev, flush, cfg, fills: dict) -> list:
    """``int8_matmul_batched`` at moonshot's up/gate and down with the fills
    a run's routing gave (``fills``: {"<regime>_run_fill": (E,) int32 on the
    card}, the regime's C from :func:`moe_rows`), held
    bit-equal to its plain version with the same ``rows``, timed, and
    bounded (:func:`batched_bounds`) over the bytes and operations that
    fill needs and over every expert's."""
    from repro_torch.kernels.int8_matmul import int8_matmul_batched, int8_matmul_batched_ref

    g = torch.Generator(device=dev).manual_seed(27)
    E, D, FE = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    out = []
    for regime, fill in fills.items():
        c = moe_rows(cfg)[regime.removesuffix("_run_fill")][1]
        for k, n in ((D, FE), (FE, D)):
            xq = torch.randint(-127, 128, (E, c, k), generator=g, device=dev, dtype=torch.int8)
            w = torch.randint(-127, 128, (E, n, k), generator=g, device=dev, dtype=torch.int8)
            dx = torch.rand(E, c, generator=g, device=dev) * 1e-2
            dw = torch.rand(E, n, generator=g, device=dev) * 1e-3
            y = int8_matmul_batched(xq, w, dx, dw, rows=fill)
            ry = int8_matmul_batched_ref(xq, w, dx, dw, rows=fill)
            torch.cuda.synchronize()
            if not torch.equal(y, ry):
                raise AssertionError(f"int8_matmul_batched ({E},{c},{k},{n}) at the run's fill "
                                     "differs from its plain version")
            del y, ry
            row = dict(shape=[E, c, k, n], regime=regime, max_abs_err=0.0,
                       **batched_bounds(fill, c, k, n),
                       **timed(torch, lambda: int8_matmul_batched(xq, w, dx, dw, rows=fill),
                               lambda: int8_matmul_batched_ref(xq, w, dx, dw, rows=fill), None,
                               20 if c > 64 else 50, flush))
            out.append(row)
            log(f"  int8_matmul_batched {regime:18s} {str(row['shape']):24s} "
                f"ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"every expert's {row['bound_every_expert_ms']:.4f} live experts "
                f"{row['live_experts']}/{E}, kept rows {row['kept_rows']}/{E * c}")
            del xq, w
    return out


def moe_kernel_phase(torch, dev, flush, cfg):
    """Every kernel of the MoE phase's path at moonshot's shapes, held
    against its plain version as :func:`kernel_phase` holds them at 7B:
    ``int8_matmul_batched`` (up/gate and down at each regime's C,
    :func:`moe_rows`) bit-equal, timed beside a bf16 ``torch.bmm`` at the
    same shapes (the yardstick: no PyTorch call computes a batched int8
    product with int32 sums); ``smooth_quant`` bit-equal on o's rows and on
    the experts' dispatched (E·C, d_model) and (E·C, moe_d_ff) rows;
    ``norm_smooth_quant`` bit-equal at d_model (attn_norm with q/k/v, the
    final norm with ``lm_head``); ``int8_matmul`` exact at q/k/v/o and
    ``lm_head``; ``int4_matmul`` exact at the W4A8 run's linears;
    ``flash_decode`` chain and (3,2,1,1) tree, contiguous, and
    ``flash_decode_paged`` chain through a block table of 128-key blocks,
    at G = 1 (16 query heads over 16 KV heads) within one bf16 rounding
    step of the plain version."""
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref, visible
    from repro_torch.kernels.int8_matmul import int8_matmul_batched, int8_matmul_batched_ref

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(19)
    E, D, FE, V = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.vocab_size
    arch = dict(arch=cfg.name)
    regimes = moe_rows(cfg)
    log(f"  MoE rows n and rows per expert C by regime: {regimes}")
    rows = []
    for regime, (_, c) in regimes.items():
        for k, n in ((D, FE), (FE, D)):
            xq = torch.randint(-127, 128, (E, c, k), generator=g, device=dev, dtype=torch.int8)
            w = torch.randint(-127, 128, (E, n, k), generator=g, device=dev, dtype=torch.int8)
            dx = torch.rand(E, c, generator=g, device=dev) * 1e-2
            dw = torch.rand(E, n, generator=g, device=dev) * 1e-3
            y = int8_matmul_batched(xq, w, dx, dw)
            ry = int8_matmul_batched_ref(xq, w, dx, dw)
            torch.cuda.synchronize()
            if not torch.equal(y, ry):
                raise AssertionError(f"int8_matmul_batched ({E},{c},{k},{n}) differs from its "
                                     "plain version")
            del y, ry
            xb = torch.randn(E, c, k, generator=g, device=dev).to(torch.bfloat16)
            wb = torch.randn(E, k, n, generator=g, device=dev).to(torch.bfloat16)
            # every row kept: every expert's weight, X and the scales read
            # once, Y written once
            bound = batched_bounds(torch.full((E,), c), c, k, n)
            iters = 20 if c > 64 else 50
            row = dict(shape=[E, c, k, n], regime=regime, max_abs_err=0.0,
                       bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                       **timed(torch, lambda: int8_matmul_batched(xq, w, dx, dw),
                               lambda: int8_matmul_batched_ref(xq, w, dx, dw), None,
                               iters, flush))
            row["yardstick_bmm_bf16_ms"] = time_ms(torch, lambda: torch.bmm(xb, wb), iters,
                                                   flush)
            rows.append(row)
            log(f"  int8_matmul_batched {regime:10s} {str(row['shape']):24s} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"bmm_bf16_ms={row['yardstick_bmm_bf16_ms']:.4f} host_ms={row['host_ms']:.4f}")
            del xq, w, xb, wb
    out = {"int8_matmul_batched": rows, "flash_decode": [], "flash_decode_tree": []}

    # -- the other kernels of the path, at the rows each regime gives them:
    #    attention (o's quantization, q/k/v/o, attn_norm with 3 readers) at
    #    every n but the paged tree's; the experts' quantization at every
    #    E·C; lm_head and the final norm (1 reader) at the decode windows;
    #    the W4A8 run (spec chain) at its chain window and prefill --
    attn_n = [n for regime, (n, _) in regimes.items() if regime != "paged_tree"]
    dec_n = [regimes[r][0] for r in ("vanilla", "chain", "paged", "tree")]
    out["smooth_quant"] = smooth_quant_rows(
        torch, dev, g, flush,
        [(n, cfg.num_heads * cfg.head_dim) for n in attn_n]
        + [(E * c, k) for _, c in regimes.values() for k in (D, FE)], **arch)
    out["norm_smooth_quant"] = (
        norm_smooth_quant_rows(torch, dev, g, flush, attn_n, D, 3, cfg.norm_eps, **arch)
        + norm_smooth_quant_rows(torch, dev, g, flush, dec_n, D, 1, cfg.norm_eps, **arch))
    out["int8_matmul"] = int8_matmul_rows(
        torch, dev, g, flush, [(n, D, D) for n in attn_n] + [(n, D, V) for n in dec_n], **arch)
    out["int4_matmul"] = int4_matmul_rows(
        torch, dev, g, flush, [(regimes[r][0], D, D) for r in ("chain", "prefill")]
        + [(regimes["chain"][0], D, V)], **arch)
    out["flash_decode_paged"] = paged_rows(torch, dev, g, flush, cfg, regimes["paged"][0] // (
        GAMMA + 1), False, False, (128,), **arch)
    for name in ("smooth_quant", "norm_smooth_quant", "int8_matmul", "int4_matmul",
                 "flash_decode_paged"):
        for r in out[name]:
            extra = "".join(f" {k}={r[k]:.4f}" for k in ("yardstick_int8_matmul_ms",
                                                           "yardstick_contiguous_ms") if k in r)
            log(f"  {name:20s} {str(r['shape']):30s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']} host_ms={r['host_ms']:.4f} "
                f"max_abs_err={r['max_abs_err']}{extra}")

    # -- flash_decode at G = 1: the MoE chain window and the (3,2,1,1) tree --
    HQ, HKV, DH = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = -(-(PROMPT + NEW + GAMMA + 2) // 128) * 128
    for name, branches in (("flash_decode", None), ("flash_decode_tree", TREE)):
        if branches is None:
            t, kw, tkw = GAMMA + 1, {}, {}
            qpos = (torch.arange(t, device=dev) + PROMPT - 1 + 17).expand(B, t)
            qpos = qpos.to(torch.int32).contiguous()
            vis = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None])
        else:
            tables = TreeTemplate(branches).on(dev)
            t = tables.depths.shape[0]
            win_start = torch.full((B,), PROMPT - 1 + 17, dtype=torch.int32, device=dev)
            qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
            kw = dict(tree_mask=tables.mask, win_start=win_start)
            tkw = dict(tree_bits=tables.mask_bits)
            vis = visible(qpos, S, tables.mask, win_start)
        q = torch.randn(B, t, HQ, DH, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, HKV, DH, generator=g, device=dev).to(torch.bfloat16)
        o = flash_decode(q, k, v, qpos, **kw, **tkw)
        ro = flash_decode_ref(q, k, v, qpos, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name} G=1: non-finite output")
        torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                   msg=lambda m: f"{name} G=1: {m}")
        err = (o.float() - ro.float()).abs().max().item()
        keys = int(vis.any(dim=1).flip(-1).int().argmax(-1).neg().add(S).sum())
        nbytes = 2 * 2 * B * t * HQ * DH + 2 * keys * HKV * DH * 2 + 4 * B * t
        bms, by = bound_ms(nbytes, 4 * HQ * int(vis.sum()) * DH, "bf16")
        mask = vis[:, None]

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask).transpose(1, 2)

        lib_err = (library().float() - ro.float()).abs().max().item()
        if lib_err > SDPA_TOL:
            raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
        row = dict(shape=[B, t, HQ, HKV, S, DH], arch=cfg.name, max_abs_err=err,
                   bound_ms=bms, bound_by=by,
                   **timed(torch, lambda: flash_decode(q, k, v, qpos, **kw, **tkw),
                           lambda: flash_decode_ref(q, k, v, qpos, **kw), library, 50, flush))
        out[name].append(row)
        log(f"  {name} G=1 {str(row['shape']):30s} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={bms:.4f} ({by}) "
            f"sdpa_ms={row['library_ms']:.4f} max_abs_err={err}")
    return out


def moe_launches_per_chain_step(layers: int) -> dict:
    """The kernel launches of one W8A8 chain step of an MoE decoder, from
    the code: per layer the attention norm (fused with q/k/v's quantization),
    q/k/v/o, o's quantization, flash_decode, and the MoE FFN's up/gate/down
    quantizations and batched GEMMs (its norm feeds the f32 router, so it does
    not fuse); then the final norm fused with lm_head's quantization, and
    lm_head."""
    return {"norm_smooth_quant": layers + 1, "smooth_quant": 4 * layers,
            "int8_matmul": 4 * layers + 1, "int8_matmul_batched": 3 * layers,
            "flash_decode": layers}


def moe_drop_hooks(params, counter, t_window: int, per_layer=None, fills=None) -> list:
    """Forward pre-hooks on every MoE layer of ``params`` that route the
    layer's input again (``moe.route``, the layer's own function on its own
    rows, so the same ``keep`` and ``fill``) and add to ``counter`` (8,)
    int64 in place its dropped and routed (token, slot) counts and its
    experts with a kept slot and experts: [0:2], [4:6] for forwards whose
    window is ``t_window`` tokens (the decode step), [2:4], [6:8] for the
    rest (prefills).  ``per_layer`` (layers, 2) int64: each layer's experts
    with a kept slot and experts over the decode forwards; ``fills``: a
    list that gets (decode?, the fill (E,) int32) of every forward.  For
    eager runs only: hooks run while a graph is captured, so a captured
    step would carry them.  Returns the hook handles."""
    from repro_torch.models import moe

    def count(i, layer, args):
        x = args[0]
        cfg = layer.cfg
        r = moe.route(moe.router_logits(x.reshape(-1, x.shape[-1]), layer.router.w),
                      cfg.experts_per_token, cfg.num_experts, cfg.moe_capacity_factor)
        keep, live = r["keep"], (r["fill"] > 0).sum()
        decode = x.shape[1] == t_window
        at = 0 if decode else 2
        counter[at].add_((~keep).sum())
        counter[at + 1].add_(keep.numel())
        counter[at + 4].add_(live)
        counter[at + 5].add_(cfg.num_experts)
        if decode and per_layer is not None:
            per_layer[i, 0].add_(live)
            per_layer[i, 1].add_(cfg.num_experts)
        if fills is not None:
            fills.append((decode, r["fill"].clone()))

    # the index rides with the hook: a step may run copies of the layers
    # (``with_config``), which share their hooks
    return [m.register_forward_pre_hook(functools.partial(count, i))
            for i, m in enumerate(m for m in params.modules() if isinstance(m, moe.MoE))]


def moe_phase(torch, dev, flush):
    """``moonshot-v1-16b-a3b`` at full width, MOE_LAYERS of its 48 layers
    (the most whose raw bf16 and prepared weights fit the card beside the
    caches: PERF.md §4), seeded random bf16 weights from the serve CLI's
    seed, s = 1, gsm8k-preset 1024-token prompts, 64 new tokens, greedy,
    every decode step through CUDA graphs.  Kernels first
    (:func:`moe_kernel_phase`); then at the config's capacity factor 1.25:
    ``generate`` at batch 4 — spec W8A8 (ngram γ 5, KV bf16), vanilla W8A8,
    tree (3,2,1,1) W8A8, spec W4A8 — and ``generate_requests`` paged W8A8
    (12 requests through 8 slots, block 128); each gated on finite logits
    and on launching ``int8_matmul_batched`` and its attention kernel, with
    a step (tick) window each (launches read just after the run, before
    anything else reaches the card).  Each run again eagerly with
    :func:`moe_drop_hooks`: replay tokens == eager tokens bit for bit, equal
    launches, and the dropped share of expert slots (decode steps apart
    from prefills).  Then the lossless gate on a dropless copy of
    the config (the same weights, capacity factor = 64 experts): spec, tree
    and pruned == vanilla, and paged == contiguous, 256-token prompts."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.core.tree import TreeTemplate
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models.transformer import with_config
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    free, total = torch.cuda.mem_get_info(dev)
    log(f"  card at the MoE phase's start: {held / 1e9:.3f} GB allocated (the L2 flush "
        f"buffer included), {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    if held > 2e9:
        raise AssertionError(f"the MoE phase needs an empty card: {held / 1e9:.2f} GB held")
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS,
                              kv_cache_dtype="bf16")
    out = {"config": dict(arch=cfg.name, num_layers=cfg.num_layers, full_depth=get_config(
        MOE_ARCH).num_layers, capacity_factor=cfg.moe_capacity_factor)}
    kern = moe_kernel_phase(torch, dev, flush, cfg)

    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
    torch.cuda.synchronize()
    raw_gb = sum(t.numel() * t.element_size() for t in raw.buffers()) / 1e9
    out["raw_gb"], out["init_s"] = raw_gb, time.perf_counter() - t0

    def prepare(verifier):
        t0 = time.perf_counter()
        prep = SpecEngine(model, SpecConfig(verifier=verifier)).prepare_params(raw)
        torch.cuda.synchronize()
        own = {id(t) for t in raw.buffers()}
        gb = sum(t.numel() * t.element_size() for t in prep.buffers() if id(t) not in own) / 1e9
        out[f"prepared_{verifier}_gb"] = gb
        out[f"prepare_{verifier}_s"] = time.perf_counter() - t0
        log(f"  prepared {verifier}: {gb:.2f} GB beside the raw {raw_gb:.2f} GB "
            f"({time.perf_counter() - t0:.1f} s); "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        return prep

    prompts_np = task_prompts(serve.TASK, PAGED_REQUESTS, PROMPT, cfg.vocab_size)
    prompts = torch.as_tensor(prompts_np[:B], device=dev, dtype=torch.int32)
    L = cfg.num_layers
    want = moe_launches_per_chain_step(L)
    runs, toks = {}, {}

    def eager_drops(name, params, scfg, t_window, run, graph_out, graph_launches,
                    fills=None):
        """The run again with ``graphs=False`` and :func:`moe_drop_hooks` on
        every MoE layer: its tokens and launches must equal the graph run's
        (replay ≡ eager), so the drops and kept experts it counts are the
        graph run's (``fills``: a list for every forward's fill).  The graph
        run's programs carry no counting ops."""
        gc.collect()
        eng = SpecEngine(model, scfg, graphs=False)
        counter = torch.zeros(8, dtype=torch.int64, device=dev)
        per_layer = torch.zeros(L, 2, dtype=torch.int64, device=dev)
        hooks = moe_drop_hooks(params, counter, t_window, per_layer, fills)
        try:
            ops.reset_launch_counts()
            got = run(eng)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            for h in hooks:
                h.remove()
        if not torch.equal(got, graph_out):
            raise AssertionError(f"moe {name}: eager tokens differ from replayed tokens")
        if launches != graph_launches:
            raise AssertionError(f"moe {name}: launches differ between graphs and eager: "
                                 f"{launches} != {graph_launches}")
        d_dec, r_dec, d_other, r_other, l_dec, e_dec, l_other, e_other = counter.tolist()
        del eng
        return dict(dropped_share_decode=d_dec / max(r_dec, 1),
                    dropped_share_prefill=d_other / max(r_other, 1),
                    live_expert_share_decode=l_dec / max(e_dec, 1),
                    live_expert_share_prefill=l_other / max(e_other, 1),
                    live_expert_share_decode_by_layer=[
                        a / max(b, 1) for a, b in per_layer.tolist()])

    def generate_run(name, params, verifier, drafter, branches, needed, fills=None):
        scfg = SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier,
                          tree_branches=branches)
        eng = SpecEngine(model, scfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r = eng.generate(params, prompts, NEW)
        torch.cuda.synchronize()
        info = dict(launches=ops.launch_counts(), tok_s=r.tokens_per_s, L=r.mean_accept_len,
                    steps=r.steps, new_tokens=r.new_tokens, decode_s=r.wall_s,
                    prefill_s=r.prefill_s,
                    mean_step_ms=1e3 * (r.wall_s - r.capture_s) / max(r.steps, 1),
                    capture_ms=1e3 * r.capture_s, step_traces=eng.step_traces,
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    bad_rows=int(r.bad.sum()))
        missing = [k for k in needed if info["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"moe {name}: kernels never launched on the path: {missing}")
        if info["bad_rows"]:
            raise AssertionError(f"moe {name}: non-finite verifier logits in "
                                 f"{info['bad_rows']} rows")
        if r.new_tokens != B * NEW:
            raise AssertionError(f"moe {name}: {r.new_tokens} new tokens, expected {B * NEW}")
        info["window"] = step_window(torch, eng, params, prompts)
        toks[name] = r.tokens[:, PROMPT:PROMPT + NEW].cpu()
        graph_out = r.tokens
        del eng, r
        t_window = (TreeTemplate(branches).num_nodes if branches
                    else 1 if drafter == "vanilla" else GAMMA + 1)
        info.update(eager_drops(name, params, scfg, t_window,
                                lambda e: e.generate(params, prompts, NEW).tokens, graph_out,
                                info["launches"], fills))
        log(f"  moe {name}: {json.dumps(info)}")
        return info

    # -- W8A8 at the config's capacity factor (1.25): slots may drop --
    prep = prepare("w8a8")
    attn = ("int8_matmul_batched", "int8_matmul", "smooth_quant", "norm_smooth_quant")
    fills = []
    runs["moe_spec_w8a8"] = generate_run("spec_w8a8", prep, "w8a8", "ngram", None,
                                         attn + ("flash_decode",), fills)
    spec = runs["moe_spec_w8a8"]
    per_step = spec["window"]["launches_per_step"]
    if per_step != want:
        raise AssertionError(f"moe W8A8 chain step launches {per_step}, expected {want}")
    log(f"  moe spec W8A8 graph step: device busy {spec['window']['device_busy_ms_per_step']} "
        f"ms, step {spec['window']['step_ms']:.3f} ms, batched kernel in the graph "
        f"{spec['window']['in_graph_ms_per_launch'].get('int8_matmul_batched')} ms per "
        f"launch; experts keeping a slot: {spec['live_expert_share_decode']:.4f} of decode "
        f"passes, {spec['live_expert_share_prefill']:.4f} at prefill")
    # the batched kernel at the run's own fills: the decode pass and the
    # prefill pass at the median share of experts keeping a slot
    picked = {}
    for regime, decode in (("chain_run_fill", True), ("prefill_run_fill", False)):
        seen = sorted((f for d, f in fills if d == decode), key=lambda f: int((f > 0).sum()))
        picked[regime] = seen[len(seen) // 2]
    del fills
    kern["int8_matmul_batched"].extend(batched_fill_rows(torch, dev, flush, cfg, picked))
    out["run_fills"] = {k: v.tolist() for k, v in picked.items()}
    runs["moe_vanilla_w8a8"] = generate_run("vanilla_w8a8", prep, "w8a8", "vanilla", None,
                                            attn + ("flash_decode",))
    runs["moe_tree_w8a8"] = generate_run("tree_w8a8", prep, "w8a8", "ngram-tree", TREE,
                                         attn + ("flash_decode_tree",))
    log("  moe spec, vanilla and tree W8A8: eager tokens == replayed tokens, bit for bit; "
        "launches equal")
    for name in ("spec_w8a8", "tree_w8a8"):
        share = (toks[name] == toks["vanilla_w8a8"]).float().mean().item()
        runs[f"moe_{name}"]["vs_vanilla_shared_tokens"] = share
        log(f"  moe {name} vs vanilla at capacity factor {cfg.moe_capacity_factor}: "
            f"{share:.4f} of greedy tokens shared (drops make a row depend on its batch)")

    # paged: 12 requests through 8 slots, block 128
    scfg = SpecConfig(gamma=GAMMA, drafter="ngram", verifier="w8a8", kv_layout="paged",
                      kv_block_size=128)
    eng = SpecEngine(model, scfg)
    reqs = [GenerationRequest(p, NEW, seed=i) for i, p in enumerate(prompts_np)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate_requests(prep, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g0 = eng.group_stats[0]
    info = dict(launches=ops.launch_counts(), served_tok_s=sum(r.new_tokens for r in res) / wall,
                wall_s=wall, steps=g0["steps"], L=sum(r.accept_len for r in res) / len(res),
                capture_ms=1e3 * eng.capture_s, step_traces=eng.step_traces,
                bad_rows=sum(int(r.bad) for r in res), peak_blocks=g0.get("peak_blocks"))
    if info["bad_rows"] or any(r.tokens.size != NEW for r in res):
        raise AssertionError("moe paged W8A8: a request failed or tripped the NaN flag")
    missing = [k for k in attn + ("flash_decode_paged",) if info["launches"].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"moe paged W8A8: kernels never launched on the path: {missing}")
    info["window"] = tick_window(torch, eng, prep, window_requests(prompts_np))
    paged_out = torch.as_tensor(np.stack([r.tokens for r in res]))
    del eng, res
    # the eager pass's "prefill" share is the admissions' prefills (any
    # forward whose window is not the decode step's γ+1)
    info.update(eager_drops("paged_w8a8", prep, scfg, GAMMA + 1, lambda e: torch.as_tensor(
        np.stack([r.tokens for r in e.generate_requests(prep, reqs)])), paged_out,
        info["launches"]))
    runs["moe_paged_w8a8"] = info
    log(f"  moe paged_w8a8: {json.dumps(info)}")

    # -- the dropless lossless gate: the same weights, capacity factor = E --
    cfg_d = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    model_d = Model(cfg_d, device=dev)
    prep_d = with_config(prep, cfg_d)
    gp = torch.as_tensor(task_prompts(serve.TASK, 2, MOE_GATE_PROMPT, cfg.vocab_size),
                         device=dev, dtype=torch.int32)
    gate = {}
    for name, kw in (("vanilla", dict(drafter="vanilla")), ("ngram", dict(drafter="ngram")),
                     ("ngram-tree", dict(drafter="ngram-tree", tree_branches=TREE)),
                     ("pruned", dict(drafter="pruned", pruned_retention=0.75))):
        r = SpecEngine(model_d, SpecConfig(gamma=GAMMA, verifier="w8a8", **kw)).generate(
            prep_d, gp, MOE_GATE_NEW)
        if bool(r.bad.any()):
            raise AssertionError(f"moe dropless {name}: non-finite logits")
        gate[name] = r.tokens[:, :MOE_GATE_PROMPT + MOE_GATE_NEW].cpu()
    for name in ("ngram", "ngram-tree", "pruned"):
        if not torch.equal(gate[name], gate["vanilla"]):
            raise AssertionError(f"moe dropless: greedy {name} != vanilla on the card")
    gate_reqs = [GenerationRequest(p, MOE_GATE_NEW, seed=i) for i, p in enumerate(
        task_prompts(serve.TASK, 4, MOE_GATE_PROMPT, cfg.vocab_size))]
    lay = {}
    for layout in ("paged", "contiguous"):
        res = SpecEngine(model_d, SpecConfig(gamma=GAMMA, verifier="w8a8", kv_layout=layout,
                                             kv_block_size=128)).generate_requests(
            prep_d, gate_reqs, batch_slots=2)
        if any(bool(r.bad) for r in res):
            raise AssertionError(f"moe dropless {layout}: non-finite logits")
        lay[layout] = np.stack([r.tokens for r in res])
    if not np.array_equal(lay["paged"], lay["contiguous"]):
        raise AssertionError("moe dropless: paged tokens != contiguous tokens")
    log(f"  moe dropless ({MOE_GATE_PROMPT}-token prompts): ngram, ngram-tree, pruned == "
        "vanilla; paged == contiguous (4 requests, 2 slots)")
    out["dropless_gate"] = dict(prompt=MOE_GATE_PROMPT, new_tokens=MOE_GATE_NEW, held=True)
    del prep_d, model_d, prep
    gc.collect()
    torch.cuda.empty_cache()

    # -- W4A8: the attention linears and lm_head int4, the experts int8 --
    prep = prepare("w4a8")
    runs["moe_spec_w4a8"] = generate_run(
        "spec_w4a8", prep, "w4a8", "ngram", None,
        ("int8_matmul_batched", "int4_matmul", "smooth_quant", "norm_smooth_quant",
         "flash_decode"))
    out["replay_equals_eager"] = sorted(runs)
    del prep, raw
    gc.collect()
    torch.cuda.empty_cache()
    out["runs"] = runs
    return out, kern

def ssd_update_rows(torch, dev, g, flush, shapes, **tag) -> list:
    """``ssd_update`` at each (B, T, H, P, N, collect) of ``shapes``: states
    bit-equal to its plain version (the token loop), y within rtol 1e-5 /
    atol 1e-4 (the two sum N f32 products in different orders), timed
    beside it.  Its bound is bytes: h0 and x, B, C, dt read once, y and the
    kept states (every window position's with ``collect``) written once.
    No PyTorch call computes the recurrence: library_ms stays null."""
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
    from repro_torch.models.ssm import softplus

    rows = []
    for b, t, h, p, n, collect in shapes:
        x = torch.randn(b, t, h, p, generator=g, device=dev)
        bm = torch.randn(b, t, n, generator=g, device=dev)
        cm = torch.randn(b, t, n, generator=g, device=dev)
        dt = softplus(torch.randn(b, t, h, generator=g, device=dev) - 4.0)
        a = torch.linspace(1.0, 16.0, h, device=dev)
        h0 = torch.randn(b, h, p, n, generator=g, device=dev) * 0.5
        args = (x, bm, cm, dt, a, h0, collect)
        y, st = ssd_update(*args)
        ry, rst = ssd_update_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(st, rst):
            raise AssertionError(f"ssd_update {(b, t, h, p, n, collect)}: states are not "
                                 "bit-equal to the plain version's")
        torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"ssd_update {(b, t, h, p, n)}: {m}")
        kept = b * t * h * p * n if collect else b * h * p * n
        nbytes = 4 * (2 * b * t * h * p + 2 * b * t * n + b * t * h + h + b * h * p * n + kept)
        bms, by = bound_ms(nbytes, 5 * b * t * h * p * n, "f32")
        rows.append(dict(shape=[b, t, h, p, n], collect_states=collect, **tag,
                         max_abs_err=(y - ry).abs().max().item(), bound_ms=bms, bound_by=by,
                         **timed(torch, lambda: ssd_update(*args),
                                 lambda: ssd_update_ref(*args), None, 50, flush)))
    return rows


def ssm_kernel_phase(torch, dev, flush) -> dict:
    """Every kernel of the SSM phase's path at zamba2-2.7b's and
    mamba2-370m's shapes, against its plain version: ``ssd_update`` at the
    chain (T = γ+1) and vanilla (T = 1) windows with every state kept and at
    the pruned draft's T = 1 without; chain ``flash_decode`` at zamba2's
    head size 80 (bf16 and int8 K/V, beside SDPA); ``int8_matmul`` and
    ``int4_matmul`` at ``in_proj`` (N 10448 and 4384: not multiples of 64),
    ``out_proj``, the shared block's linears and zamba2's ``lm_head``;
    ``norm_smooth_quant`` at the SSM pre-norm (1 reader) and the shared
    block's norms (3 and 2); ``smooth_quant`` at ``out_proj``'s and the
    shared o's and down's inputs."""
    from repro_torch.configs import get_config

    g = torch.Generator(device=dev).manual_seed(20)
    z, m2 = get_config(SSM_ARCHS[0]), get_config(SSM_ARCHS[1])
    M = B * (GAMMA + 1)
    out = {}
    shapes = []
    for cfg in (z, m2):
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        shapes += [(B, GAMMA + 1, H, P, N, True), (B, 1, H, P, N, True), (B, 1, H, P, N, False)]
    out["ssd_update"] = ssd_update_rows(torch, dev, g, flush, shapes)
    S = -(-(PROMPT + NEW + GAMMA + 2) // 128) * 128
    out["flash_decode_dh80"] = flash_chain_rows(torch, dev, g, flush, z.num_heads,
                                                z.num_kv_heads, z.head_dim, S, False,
                                                arch=z.name)
    out["flash_decode_int8_dh80"] = flash_chain_rows(torch, dev, g, flush, z.num_heads,
                                                     z.num_kv_heads, z.head_dim, S, True,
                                                     arch=z.name)
    gemms = []
    for cfg in (z, m2):
        D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        gemms += [(M, D, 2 * di + 2 * N + H), (B, D, 2 * di + 2 * N + H), (M, di, D)]
    gemms += [(M, z.d_model, z.q_dim), (M, z.d_model, z.d_ff), (M, z.d_ff, z.d_model),
              (M, z.d_model, z.vocab_size)]
    out["int8_matmul"] = int8_matmul_rows(torch, dev, g, flush, gemms, phase="ssm")
    out["int4_matmul"] = int4_matmul_rows(torch, dev, g, flush, gemms, phase="ssm")
    out["norm_smooth_quant"] = (
        norm_smooth_quant_rows(torch, dev, g, flush, (B, M), z.d_model, 1, z.norm_eps,
                               phase="ssm", arch=z.name)
        + norm_smooth_quant_rows(torch, dev, g, flush, (M,), z.d_model, 3, z.norm_eps,
                                 phase="ssm", arch=z.name)
        + norm_smooth_quant_rows(torch, dev, g, flush, (M,), z.d_model, 2, z.norm_eps,
                                 phase="ssm", arch=z.name)
        + norm_smooth_quant_rows(torch, dev, g, flush, (B, M), m2.d_model, 1, m2.norm_eps,
                                 phase="ssm", arch=m2.name))
    out["smooth_quant"] = smooth_quant_rows(
        torch, dev, g, flush, ((M, z.d_inner), (M, m2.d_inner), (M, z.q_dim), (M, z.d_ff)),
        phase="ssm")
    for name, rows in out.items():
        for r in rows:
            log(f"  {name:22s} {str(r['shape']):32s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']}")
    return out


def ssm_launches_per_chain_step(cfg) -> dict:
    """The kernel launches of one W8A8 chain step of an SSM or hybrid
    decoder, from the code: per SSM layer the pre-norm (fused with
    in_proj's quantization), in_proj, ssd_update, out_proj's quantization
    and out_proj; per shared-block application attn_norm (fused with q/k/v),
    q/k/v, flash_decode, o's quantization and o, ffn_norm (fused with
    gate/up), gate/up, down's quantization and down; then the final norm
    fused with lm_head's quantization and lm_head, or, tied (mamba2), the
    f32 logits product, no kernel of ours."""
    from repro_torch.models.transformer import shared_attn_positions

    L, A = cfg.num_layers, len(shared_attn_positions(cfg))
    tied = cfg.tie_embeddings
    out = {"norm_smooth_quant": L + 2 * A + (0 if tied else 1), "smooth_quant": L + 2 * A,
           "int8_matmul": 2 * L + 7 * A + (0 if tied else 1), "ssd_update": L}
    if A:
        out["flash_decode"] = A
    return out


def ssm_phase(torch, dev, flush):
    """``zamba2-2.7b`` at 54 of 54 layers and ``mamba2-370m`` at 48 of 48,
    seeded random bf16 weights from the serve CLI's seed, s = 1,
    gsm8k-preset 1024-token prompts, batch 4, 64 new tokens, greedy, every
    decode step through CUDA graphs, the card empty at the start.  Kernels
    first (:func:`ssm_kernel_phase`).  zamba2: ``generate`` with spec W8A8
    (ngram γ 5, KV bf16), vanilla W8A8, spec and vanilla W4A8, spec and
    vanilla W8A8 over an int8 KV cache, pruned W8A8 (retention 0.75), and
    contiguous ``generate_requests`` (8 equal-length requests through 4
    slots); mamba2: spec and vanilla W8A8.  Each run: launches read just
    after it, a step (tick) window (unprofiled step ms, device busy ms per
    step, idle share, launches per step), L, tokens/s, capture ms,
    ``step_traces`` (one program), the share of its new tokens that occur
    earlier in their row (all prompt lookup can draft); then again eagerly
    (``graphs=False``): tokens and launches equal, bit for bit.  The W4A8
    and int8-KV vanilla runs, there for the gates, skip the window and the
    eager pass.  Gates: finite logits, every
    kernel of the path launched, the W8A8 chain step's launches equal to
    :func:`ssm_launches_per_chain_step`, greedy spec and pruned tokens ==
    vanilla's of the same verifier and KV cache, and the scheduled
    requests' tokens == the spec run's rows."""
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

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    log(f"  card at the SSM phase's start: {held / 1e9:.3f} GB allocated (the L2 flush "
        "buffer included)")
    if held > 2e9:
        raise AssertionError(f"the SSM phase needs an empty card: {held / 1e9:.2f} GB held")
    t_phase = time.perf_counter()
    kern = ssm_kernel_phase(torch, dev, flush)
    out = {"kernel_phase_s": time.perf_counter() - t_phase}
    runs, toks, replayed = {}, {}, []
    base = ("norm_smooth_quant", "smooth_quant", "ssd_update")

    def replay_equals_eager(name, model, scfg, run, graph_out, graph_launches):
        """The run again with ``graphs=False``: tokens and launches equal."""
        gc.collect()
        eng = SpecEngine(model, scfg, graphs=False)
        ops.reset_launch_counts()
        got = run(eng)
        torch.cuda.synchronize()
        if not torch.equal(got, graph_out):
            raise AssertionError(f"{name}: eager tokens differ from replayed tokens")
        if ops.launch_counts() != graph_launches:
            raise AssertionError(f"{name}: launches differ between graphs and eager: "
                                 f"{ops.launch_counts()} != {graph_launches}")

    def seen_share(tokens) -> float:
        """Share of the new tokens that already occur earlier in their row
        (prompt or output): prompt lookup can draft a token only from
        there."""
        t = tokens.cpu().numpy()
        seen = [t[b, i] in set(t[b, :i].tolist()) for b in range(t.shape[0])
                for i in range(PROMPT, PROMPT + NEW)]
        return sum(seen) / len(seen)

    def generate_run(name, model, params, prompts, verifier, drafter, needed, full=True,
                     **kw):
        """One ``generate`` through graphs; ``full`` adds its step window and
        its eager pass (replay ≡ eager)."""
        t_run = time.perf_counter()
        scfg = SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier, **kw)
        eng = SpecEngine(model, scfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r = eng.generate(params, prompts, NEW)
        torch.cuda.synchronize()
        info = dict(launches=ops.launch_counts(), tok_s=r.tokens_per_s, L=r.mean_accept_len,
                    steps=r.steps, new_tokens=r.new_tokens, decode_s=r.wall_s,
                    prefill_s=r.prefill_s,
                    mean_step_ms=1e3 * (r.wall_s - r.capture_s) / max(r.steps, 1),
                    capture_ms=1e3 * r.capture_s, step_traces=eng.step_traces,
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    bad_rows=int(r.bad.sum()))
        missing = [k for k in needed if info["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
        if info["bad_rows"]:
            raise AssertionError(f"{name}: non-finite verifier logits in "
                                 f"{info['bad_rows']} rows")
        if r.new_tokens != B * NEW:
            raise AssertionError(f"{name}: {r.new_tokens} new tokens, expected {B * NEW}")
        if info["step_traces"] != 1:
            raise AssertionError(f"{name}: {info['step_traces']} programs, expected 1")
        info["seen_share"] = seen_share(r.tokens[:, :PROMPT + NEW])
        if full:
            info["window"] = step_window(torch, eng, params, prompts)
        graph_out = r.tokens
        toks[name] = r.tokens[:, PROMPT:PROMPT + NEW].cpu()
        del eng, r
        info["graph_s"] = time.perf_counter() - t_run
        if full:
            t_eager = time.perf_counter()
            replay_equals_eager(name, model, scfg,
                                lambda e: e.generate(params, prompts, NEW).tokens, graph_out,
                                info["launches"])
            info["eager_s"] = time.perf_counter() - t_eager
            replayed.append(name)
        w = info.get("window", {})
        log(f"  {name}: L={info['L']:.3f} steps={info['steps']} tok/s={info['tok_s']:.1f} "
            f"seen_share={info['seen_share']:.3f} step_ms={w.get('step_ms')} "
            f"busy_ms={w.get('device_busy_ms_per_step')} idle={w.get('device_idle_share')} "
            f"capture_ms={info['capture_ms']:.1f} launches/step={w.get('launches_per_step')} "
            f"graph_s={info['graph_s']:.1f} eager_s={info.get('eager_s')}")
        return info

    def gate(name, ref):
        if not torch.equal(toks[name], toks[ref]):
            share = (toks[name] == toks[ref]).float().mean().item()
            raise AssertionError(f"greedy {name} tokens differ from {ref}'s ({share:.4f} "
                                 "shared)")
        runs[name]["vs_vanilla_shared_tokens"] = 1.0

    for arch in SSM_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        model = Model(cfg, device=dev)
        raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
        prompts_np = task_prompts(serve.TASK, 2 * B, PROMPT, cfg.vocab_size)
        prompts = torch.as_tensor(prompts_np[:B], device=dev, dtype=torch.int32)
        attn = ("flash_decode",) if cfg.arch_type == "hybrid" else ()
        tag = arch.split("-")[0]
        info = dict(arch=arch, num_layers=cfg.num_layers,
                    raw_gb=sum(t.numel() * t.element_size() for t in raw.buffers()) / 1e9)
        for verifier in ("w8a8", "w4a8") if cfg.arch_type == "hybrid" else ("w8a8",):
            prep = SpecEngine(model, SpecConfig(verifier=verifier)).prepare_params(raw)
            gemm = ("int8_matmul",) if verifier == "w8a8" else ("int4_matmul",)
            need = base + gemm + attn
            runs[f"{tag}_spec_{verifier}"] = generate_run(
                f"{tag}_spec_{verifier}", model, prep, prompts, verifier, "ngram", need)
            runs[f"{tag}_vanilla_{verifier}"] = generate_run(
                f"{tag}_vanilla_{verifier}", model, prep, prompts, verifier, "vanilla", need,
                full=verifier == "w8a8")
            gate(f"{tag}_spec_{verifier}", f"{tag}_vanilla_{verifier}")
            if verifier != "w8a8":
                del prep
                continue
            per_step = runs[f"{tag}_spec_w8a8"]["window"]["launches_per_step"]
            want = ssm_launches_per_chain_step(cfg)
            if per_step != want:
                raise AssertionError(f"{arch} W8A8 chain step launches {per_step}, "
                                     f"expected {want}")
            if cfg.arch_type == "hybrid":
                model8 = Model(dataclasses.replace(cfg, kv_cache_dtype="int8"), device=dev)
                need8 = base + gemm + ("flash_decode_int8",)
                runs[f"{tag}_spec_w8a8_kv_int8"] = generate_run(
                    f"{tag}_spec_w8a8_kv_int8", model8, prep, prompts, "w8a8", "ngram", need8)
                runs[f"{tag}_vanilla_w8a8_kv_int8"] = generate_run(
                    f"{tag}_vanilla_w8a8_kv_int8", model8, prep, prompts, "w8a8", "vanilla",
                    need8, full=False)
                gate(f"{tag}_spec_w8a8_kv_int8", f"{tag}_vanilla_w8a8_kv_int8")
                runs[f"{tag}_pruned_w8a8"] = generate_run(
                    f"{tag}_pruned_w8a8", model, prep, prompts, "w8a8", "pruned", need,
                    pruned_retention=0.75)
                gate(f"{tag}_pruned_w8a8", f"{tag}_vanilla_w8a8")
                # contiguous generate_requests: 8 equal-length requests, 4 slots
                scfg = SpecConfig(gamma=GAMMA, drafter="ngram", verifier="w8a8")
                reqs = [GenerationRequest(p, NEW, seed=i) for i, p in enumerate(prompts_np)]
                eng = SpecEngine(model, scfg)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t_run = t0 = time.perf_counter()
                res = eng.generate_requests(prep, reqs, batch_slots=B)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                g0 = eng.group_stats[0]
                sched = dict(launches=ops.launch_counts(), wall_s=wall, steps=g0["steps"],
                             served_tok_s=sum(r.new_tokens for r in res) / wall,
                             L=sum(r.accept_len for r in res) / len(res),
                             capture_ms=1e3 * eng.capture_s, step_traces=eng.step_traces,
                             bad_rows=sum(int(r.bad) for r in res))
                if sched["bad_rows"] or any(r.tokens.size != NEW for r in res):
                    raise AssertionError(f"{tag} generate_requests: a request failed or "
                                         "tripped the NaN flag")
                missing = [k for k in need if sched["launches"].get(k, 0) <= 0]
                if missing:
                    raise AssertionError(f"{tag} generate_requests: kernels never launched "
                                         f"on the path: {missing}")
                if sched["step_traces"] != 1:
                    raise AssertionError(f"{tag} generate_requests: {sched['step_traces']} "
                                         "programs, expected 1")
                got = torch.as_tensor(np.stack([r.tokens for r in res]))
                if not torch.equal(got[:B], toks[f"{tag}_spec_w8a8"]):
                    raise AssertionError(f"{tag} generate_requests: tokens differ from the "
                                         "spec run's rows")
                sched["window"] = tick_window(torch, eng, prep, window_requests(prompts_np))
                del eng, res
                sched["graph_s"] = time.perf_counter() - t_run
                t_eager = time.perf_counter()
                replay_equals_eager(f"{tag}_requests_w8a8", model, scfg, lambda e: torch.as_tensor(
                    np.stack([r.tokens for r in e.generate_requests(prep, reqs,
                                                                    batch_slots=B)])),
                    got, sched["launches"])
                sched["eager_s"] = time.perf_counter() - t_eager
                replayed.append(f"{tag}_requests_w8a8")
                runs[f"{tag}_requests_w8a8"] = sched
                log(f"  {tag}_requests_w8a8: {json.dumps(sched)}")
                del model8
            del prep
        del raw, model
        gc.collect()
        torch.cuda.empty_cache()
        info["phase_s"] = time.perf_counter() - t_arch
        out[tag] = info
    out["replay_equals_eager"] = sorted(replayed)
    out["runs"] = runs
    return out, kern

def cross_rows(torch, dev, g, flush, shapes, **tag) -> list:
    """The cross-attention read (``models/attention.cross_attend``) at each
    (B, T, Hq, Hkv, Sa, dh) of ``shapes``: within one bf16 rounding step of
    its plain version, a row's bits the same at T = 1 as in the window and
    at B = 1 as in the batch, timed beside the plain version and SDPA (no
    mask: every key is visible)."""
    from repro_torch.kernels.flash_decode import flash_decode_ref
    from repro_torch.models.attention import cross_attend

    F = torch.nn.functional
    rows = []
    for b, t, hq, hkv, sa, dh in shapes:
        q = torch.randn(b, t, hq, dh, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
        qpos = torch.full((b, t), sa - 1, dtype=torch.int32, device=dev)
        o = cross_attend(q, k, v)
        ro = flash_decode_ref(q, k, v, qpos)
        torch.cuda.synchronize()
        if not torch.isfinite(o).all():
            raise AssertionError(f"cross read {(b, t, hq, hkv, sa, dh)}: non-finite output")
        torch.testing.assert_close(o.float(), ro.float(), **FLASH_TOL,
                                   msg=lambda m: f"cross read {(b, t, hq, sa, dh)}: {m}")
        for i in range(t):
            if not torch.equal(cross_attend(q[:, i:i + 1].contiguous(), k, v), o[:, i:i + 1]):
                raise AssertionError(f"cross read: window row {i} differs from T = 1")
        for i in range(b):
            one = cross_attend(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                               v[i:i + 1].contiguous())
            if not torch.equal(one, o[i:i + 1]):
                raise AssertionError(f"cross read: batch row {i} differs from B = 1")

        def library():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2),
                                                  enable_gqa=True).transpose(1, 2)

        lib_err = (library().float() - ro.float()).abs().max().item()
        if lib_err > SDPA_TOL:
            raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
        nbytes = 2 * 2 * b * t * hq * dh + 2 * 2 * b * sa * hkv * dh
        bms, by = bound_ms(nbytes, 4 * b * t * hq * sa * dh, "bf16")
        rows.append(dict(shape=[b, t, hq, hkv, sa, dh], **tag,
                         max_abs_err=(o.float() - ro.float()).abs().max().item(),
                         bound_ms=bms, bound_by=by, rows_equal_t1_and_b1=True,
                         **timed(torch, lambda: cross_attend(q, k, v),
                                 lambda: flash_decode_ref(q, k, v, qpos), library, 50, flush)))
    return rows


def families_kernel_phase(torch, dev, flush) -> dict:
    """Every kernel of the families phase's path at its shapes, against its
    plain version: ``flash_decode`` at stablelm-12b's head size 160 (32/8
    heads) — chain and (3,2,1,1) tree, bf16 and int8 K/V, and through a
    block table (block 128) — and at codeqwen's 32/32 heads (G = 1); the
    cross-attention read at llama-3.2-vision's (64/8 heads, 1600 image
    tokens, dh 128) and whisper's (12/12, 1500 frames, dh 64) shapes, rows
    against T and B; ``int8_matmul`` and ``int4_matmul`` at the four
    models' linears (chain window, M 24); ``norm_smooth_quant`` at d 4096,
    5120 (3 readers) and 8192 (3, and 1: the cross q); ``smooth_quant``
    at the o and down inputs (up to vision's 28672)."""
    from repro_torch.configs import get_config

    g = torch.Generator(device=dev).manual_seed(21)
    cq, sl, vi, wh = (get_config(a) for a in FAMILY_ARCHS)
    M = B * (GAMMA + 1)
    S = -(-(PROMPT + NEW + GAMMA + 2) // 128) * 128
    out = {}
    out["flash_decode_dh160"] = flash_chain_rows(torch, dev, g, flush, sl.num_heads,
                                                 sl.num_kv_heads, sl.head_dim, S, False,
                                                 arch=sl.name)
    out["flash_decode_int8_dh160"] = flash_chain_rows(torch, dev, g, flush, sl.num_heads,
                                                      sl.num_kv_heads, sl.head_dim, S, True,
                                                      arch=sl.name)
    for name, int8 in (("flash_decode_tree_dh160", False), ("flash_decode_tree_int8_dh160", True)):
        out[name] = flash_tree_rows(torch, dev, g, flush, sl.num_heads, sl.num_kv_heads,
                                    sl.head_dim, (TREE,), int8, arch=sl.name)
    out["flash_decode_paged_dh160"] = paged_rows(torch, dev, g, flush, sl, B, False, False,
                                                 (128,), arch=sl.name)
    out["flash_decode_paged_tree_int8_dh160"] = paged_rows(torch, dev, g, flush, sl, B, True,
                                                           True, (128,), arch=sl.name)
    out["flash_decode_g1_kv32"] = flash_chain_rows(torch, dev, g, flush, cq.num_heads,
                                                   cq.num_kv_heads, cq.head_dim, S, False,
                                                   arch=cq.name)
    out["flash_decode_cross"] = cross_rows(
        torch, dev, g, flush,
        ((B, GAMMA + 1, vi.num_heads, vi.num_kv_heads, vi.num_image_tokens, vi.head_dim),
         (B, GAMMA + 1, wh.num_heads, wh.num_kv_heads, wh.num_audio_frames, wh.head_dim)))
    gemms = []
    for cfg in (cq, sl, vi, wh):
        D, FF, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
        gemms += [(M, D, cfg.q_dim), (M, D, cfg.kv_dim), (M, D, FF), (M, FF, D), (M, D, V)]
    gemms = list(dict.fromkeys(gemms))           # codeqwen's q and k/v share a shape
    log("  families: attention rows done")
    out["int8_matmul"] = int8_matmul_rows(torch, dev, g, flush, gemms, phase="families")
    out["int4_matmul"] = int4_matmul_rows(torch, dev, g, flush, gemms, phase="families")
    nsq = []
    for cfg, readers in ((cq, 3), (sl, 3), (vi, 3), (vi, 1)):
        nsq += norm_smooth_quant_rows(torch, dev, g, flush, (B, M), cfg.d_model, readers,
                                      cfg.norm_eps, phase="families", arch=cfg.name)
    out["norm_smooth_quant"] = nsq
    out["smooth_quant"] = smooth_quant_rows(
        torch, dev, g, flush, ((M, cq.d_ff), (M, sl.q_dim), (M, sl.d_ff), (M, vi.q_dim),
                               (M, vi.d_ff), (M, wh.d_model), (M, wh.d_ff)),
        phase="families")
    for name, rows in out.items():
        for r in rows:
            log(f"  {name:34s} {str(r['shape']):32s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']}")
    return out


def families_launches_per_chain_step(cfg, layers: int) -> dict:
    """The kernel launches of one W8A8 chain step of the first ``layers``
    layers of a dense, cross-attention or whisper model, from the code.
    Per dense layer: attn_norm fused with q/k/v's quantization, q/k/v,
    flash_decode, o's quantization and o, ffn_norm fused with gate/up,
    gate/up, down's quantization and down.  Per cross layer the same with
    one reader (q) and the cross read (``flash_decode_cross``) in place of
    the self read.  Per whisper block (LayerNorm: nothing fuses) each of its
    eight linears (q/k/v/o, cross q/o, up, down) quantizes its own input,
    beside flash_decode and the cross read.  Then the final norm fused with
    lm_head's quantization and lm_head, or, tied (whisper), the f32 logits
    product, no kernel of ours."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)[:layers]
    n = {k: kinds.count(k) for k in ("dense", "cross", "audio")}
    if n["audio"]:
        return {"smooth_quant": 8 * n["audio"], "int8_matmul": 8 * n["audio"],
                "flash_decode": n["audio"], "flash_decode_cross": n["audio"]}
    out = {"norm_smooth_quant": 2 * layers + 1, "smooth_quant": 2 * layers,
           "int8_matmul": 7 * n["dense"] + 5 * n["cross"] + 1, "flash_decode": n["dense"]}
    if n["cross"]:
        out["flash_decode_cross"] = n["cross"]
    return out


def families_phase(torch, dev, flush):
    """The last four families at full width, seeded random bf16 weights from
    the serve CLI's seed, s = 1, the gsm8k-preset 1024-token prompts, batch
    4, 64 new tokens, greedy, every decode step through CUDA graphs, the
    card near empty at the start of each model.  Kernels first
    (:func:`families_kernel_phase`).  codeqwen1.5-7b (32 of 32 layers) and
    stablelm-12b (40 of 40): ``generate`` with spec W8A8 (ngram γ 5),
    vanilla W8A8, tree (3,2,1,1) W8A8, spec and vanilla W4A8, spec (and,
    stablelm, tree) W8A8 over an int8 KV cache and vanilla over it, and
    (stablelm) paged W8A8 ``generate_requests`` (4 requests through 4
    slots, block 128).  llama-3.2-vision-90b at FAMILY_VISION_LAYERS of its
    100 layers (its cross layers 4, 9, 14, 19), the cross gates set to 1.0
    after init (at init they are 0 and a cross layer adds nothing), seeded
    random (B, 1600, 8192) image embeddings; whisper-small whole, seeded
    random (B, 1500, 768) frame embeddings through its encoder: spec,
    vanilla and tree W8A8.  Each run: launches read just after it, L,
    tokens/s, capture ms, one program, finite logits, every kernel of its
    path launched; the spec and vanilla W8A8 runs a step window (device
    busy ms per step, idle share, launches per step, which must be
    :func:`families_launches_per_chain_step`'s for spec); then again
    eagerly (``graphs=False``): tokens and launches equal, bit for bit.
    Gates: greedy spec, tree (KV bf16) and paged tokens == vanilla's of the
    same verifier and KV cache; the int8-KV tree run records the share of
    tokens it shares with vanilla's."""
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

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    kern = families_kernel_phase(torch, dev, flush)
    out = {"kernel_phase_s": time.perf_counter() - t_phase}
    cross_flushed = {"vision": kern["flash_decode_cross"][0]["ms"],   # cross_rows' order
                     "whisper": kern["flash_decode_cross"][1]["ms"]}
    runs, toks, replayed = {}, {}, []

    def replay_equals_eager(name, model, scfg, run, graph_out, graph_launches):
        gc.collect()
        eng = SpecEngine(model, scfg, graphs=False)
        ops.reset_launch_counts()
        got = run(eng)
        torch.cuda.synchronize()
        if not torch.equal(got, graph_out):
            raise AssertionError(f"{name}: eager tokens differ from replayed tokens")
        if ops.launch_counts() != graph_launches:
            raise AssertionError(f"{name}: launches differ between graphs and eager: "
                                 f"{ops.launch_counts()} != {graph_launches}")
        replayed.append(name)

    def generate_run(name, model, params, prompts, aux, verifier, drafter, needed,
                     window=False, **kw):
        t_run = time.perf_counter()
        scfg = SpecConfig(gamma=GAMMA, drafter=drafter, verifier=verifier, **kw)
        eng = SpecEngine(model, scfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r = eng.generate(params, prompts, NEW, aux_embeds=aux)
        torch.cuda.synchronize()
        info = dict(launches=ops.launch_counts(), tok_s=r.tokens_per_s, L=r.mean_accept_len,
                    steps=r.steps, new_tokens=r.new_tokens, decode_s=r.wall_s,
                    prefill_s=r.prefill_s,
                    mean_step_ms=1e3 * (r.wall_s - r.capture_s) / max(r.steps, 1),
                    capture_ms=1e3 * r.capture_s, step_traces=eng.step_traces,
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    bad_rows=int(r.bad.sum()))
        missing = [k for k in needed if info["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
        if info["bad_rows"]:
            raise AssertionError(f"{name}: non-finite verifier logits in "
                                 f"{info['bad_rows']} rows")
        if r.new_tokens != B * NEW:
            raise AssertionError(f"{name}: {r.new_tokens} new tokens, expected {B * NEW}")
        if info["step_traces"] != 1:
            raise AssertionError(f"{name}: {info['step_traces']} programs, expected 1")
        if window:
            info["window"] = step_window(torch, eng, params, prompts, aux_embeds=aux)
        graph_out = r.tokens
        toks[name] = r.tokens[:, PROMPT:PROMPT + NEW].cpu()
        del eng, r
        info["graph_s"] = time.perf_counter() - t_run
        t_eager = time.perf_counter()
        replay_equals_eager(name, model, scfg,
                            lambda e: e.generate(params, prompts, NEW, aux_embeds=aux).tokens,
                            graph_out, info["launches"])
        info["eager_s"] = time.perf_counter() - t_eager
        w = info.get("window", {})
        log(f"  {name}: L={info['L']:.3f} steps={info['steps']} tok/s={info['tok_s']:.1f} "
            f"step_ms={w.get('step_ms')} busy_ms={w.get('device_busy_ms_per_step')} "
            f"idle={w.get('device_idle_share')} kernels/step={w.get('device_kernels_per_step')} "
            f"in_graph_ms_per_launch={w.get('in_graph_ms_per_launch')} (cross read flushed "
            f"bench {cross_flushed.get(name.split('_')[0])} ms) capture_ms={info['capture_ms']:.1f} "
            f"launches={info['launches']} graph_s={info['graph_s']:.1f} "
            f"eager_s={info['eager_s']:.1f} peak_gb={info['peak_mem_gb']:.1f}")
        runs[name] = info
        return info

    def gate(name, ref):
        if not torch.equal(toks[name], toks[ref]):
            share = (toks[name] == toks[ref]).float().mean().item()
            raise AssertionError(f"greedy {name} tokens differ from {ref}'s ({share:.4f} "
                                 "shared)")
        runs[name]["vs_vanilla_shared_tokens"] = 1.0

    for arch in FAMILY_ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        layers = FAMILY_VISION_LAYERS if full.cross_attn_every else full.num_layers
        cfg = dataclasses.replace(full, num_layers=layers)
        tag = FAMILY_TAGS[arch]
        model = Model(cfg, device=dev)
        raw = model.init_params(torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED))
        gates = 0
        for blk in raw.layers:
            if hasattr(blk, "gate_attn"):           # 0 at init: the cross path would add 0
                blk.gate_attn.fill_(1.0)
                blk.gate_ffn.fill_(1.0)
                gates += 1
        frames = cfg.num_image_tokens or cfg.num_audio_frames
        aux = None
        if frames:
            aux = (torch.randn(B, frames, cfg.d_model,
                               generator=torch.Generator(device=dev).manual_seed(7),
                               device=dev) * 0.5).to(cfg.dtype)
        prompts = torch.as_tensor(task_prompts(serve.TASK, B, PROMPT, cfg.vocab_size),
                                  device=dev, dtype=torch.int32)
        info = dict(arch=arch, num_layers=layers, of_layers=full.num_layers,
                    cross_layers=gates,
                    raw_gb=sum(t.numel() * t.element_size() for t in raw.buffers()) / 1e9)
        attn = ("flash_decode",) + (("flash_decode_cross",) if frames else ())
        norm = () if cfg.norm == "layernorm" else ("norm_smooth_quant",)
        verifiers = ("w8a8",) if frames else ("w8a8", "w4a8")
        for verifier in verifiers:
            prep = SpecEngine(model, SpecConfig(verifier=verifier)).prepare_params(raw)
            if verifier == "w8a8":
                info["prepared_gb"] = sum(t.numel() * t.element_size()
                                          for t in prep.buffers()) / 1e9
            gemm = ("int8_matmul",) if verifier == "w8a8" else ("int4_matmul",)
            need = norm + ("smooth_quant",) + gemm + attn
            v = f"{tag}_vanilla_{verifier}"
            generate_run(v, model, prep, prompts, aux, verifier, "vanilla", need,
                         window=verifier == "w8a8")
            generate_run(f"{tag}_spec_{verifier}", model, prep, prompts, aux, verifier,
                         "ngram", need, window=verifier == "w8a8")
            gate(f"{tag}_spec_{verifier}", v)
            if verifier != "w8a8":
                del prep
                continue
            per_step = runs[f"{tag}_spec_w8a8"]["window"]["launches_per_step"]
            want = families_launches_per_chain_step(cfg, layers)
            if per_step != want:
                raise AssertionError(f"{arch} W8A8 chain step launches {per_step}, "
                                     f"expected {want}")
            generate_run(f"{tag}_tree_w8a8", model, prep, prompts, aux, "w8a8", "ngram-tree",
                         norm + ("smooth_quant", "int8_matmul", "flash_decode_tree") + attn[1:],
                         tree_branches=TREE)
            gate(f"{tag}_tree_w8a8", v)
            if not frames:        # the dense two: int8 KV (and stablelm's paged run)
                model8 = Model(dataclasses.replace(cfg, kv_cache_dtype="int8"), device=dev)
                base8 = norm + ("smooth_quant", "int8_matmul")
                generate_run(f"{tag}_vanilla_w8a8_kv_int8", model8, prep, prompts, None,
                             "w8a8", "vanilla", base8 + ("flash_decode_int8",))
                generate_run(f"{tag}_spec_w8a8_kv_int8", model8, prep, prompts, None, "w8a8",
                             "ngram", base8 + ("flash_decode_int8",))
                gate(f"{tag}_spec_w8a8_kv_int8", f"{tag}_vanilla_w8a8_kv_int8")
                if cfg.head_dim == 160:
                    # not gated on vanilla's tokens: a tree node past the root
                    # reads its ancestors at packed slots, where the kernel's
                    # chunks group and sum the keys otherwise than at the
                    # chain slots vanilla reads (the 7B's tree int8-KV run is
                    # not gated either); the shared share is recorded
                    name = f"{tag}_tree_w8a8_kv_int8"
                    generate_run(name, model8, prep, prompts, None, "w8a8", "ngram-tree",
                                 base8 + ("flash_decode_tree_int8",), tree_branches=TREE)
                    runs[name]["vs_vanilla_shared_tokens"] = (
                        toks[name] == toks[f"{tag}_vanilla_w8a8_kv_int8"]).float().mean().item()
                    # paged: 4 requests through 4 slots of 128-token blocks
                    t_run = time.perf_counter()
                    scfg = SpecConfig(gamma=GAMMA, drafter="ngram", verifier="w8a8",
                                      kv_layout="paged", kv_block_size=128)
                    reqs = [GenerationRequest(p, NEW, seed=i)
                            for i, p in enumerate(prompts.cpu().numpy())]
                    eng = SpecEngine(model, scfg)
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                    res = eng.generate_requests(prep, reqs, batch_slots=B)
                    torch.cuda.synchronize()
                    got = torch.as_tensor(np.stack([r.tokens for r in res]))
                    paged = dict(launches=ops.launch_counts(), steps=eng.group_stats[0]["steps"],
                                 L=sum(r.accept_len for r in res) / len(res),
                                 step_traces=eng.step_traces,
                                 bad_rows=sum(int(r.bad) for r in res),
                                 graph_s=time.perf_counter() - t_run)
                    if paged["bad_rows"] or paged["step_traces"] != 1:
                        raise AssertionError(f"{tag} paged: {paged}")
                    if paged["launches"].get("flash_decode_paged", 0) <= 0:
                        raise AssertionError(f"{tag} paged: flash_decode_paged never launched")
                    toks[f"{tag}_paged_w8a8"] = got
                    runs[f"{tag}_paged_w8a8"] = paged
                    gate(f"{tag}_paged_w8a8", v)
                    del eng, res
                    replay_equals_eager(f"{tag}_paged_w8a8", model, scfg, lambda e: torch.as_tensor(
                        np.stack([r.tokens for r in e.generate_requests(prep, reqs,
                                                                        batch_slots=B)])),
                        got, paged["launches"])
                    log(f"  {tag}_paged_w8a8: {json.dumps(paged)}")
                del model8
            del prep
        del raw, model, aux
        gc.collect()
        torch.cuda.empty_cache()
        info["phase_s"] = time.perf_counter() - t_arch
        log(f"  {arch}: {json.dumps(info)}")
        out[tag] = info
    out["replay_equals_eager"] = sorted(replayed)
    out["runs"] = runs
    return out, kern


def train_grad_holds(torch, dev) -> dict:
    """The kernels the bf16 forward reaches in training, under autograd:
    ``ssd_update`` at mamba2's head shapes (32 heads, P 64, N 128; batch 4,
    T 1, 6 and 16) and the cross read (``flash_decode_cross``) at
    whisper-small's (Sa 1500, 12/12 heads, dh 64) and
    llama-3.2-vision's (Sa 1600, 64/8 heads, dh 128) cross shapes (batch 2,
    T 32), f32: each launches its kernel once forward, and its gradients
    must equal the plain version's within GRAD_RTOL of each tensor's max.
    A wrapper with no backward (``smooth_quant``) must raise under grad.
    Returns the worst relative error of each hold."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode_cross, flash_decode_ref
    from repro_torch.kernels.smooth_quant import smooth_quant
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
    from repro_torch.models.ssm import softplus

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731

    def grads(fn, inputs):
        xs = [x.detach().requires_grad_(True) for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        proj = torch.Generator(device=dev).manual_seed(1)
        loss = sum((o * torch.randn(o.shape, generator=proj, device=dev)).sum() for o in outs)
        return torch.autograd.grad(loss, xs)

    def hold(name, kernel, plain, inputs, counter):
        ops.reset_launch_counts()
        got = grads(kernel, inputs)
        if ops.launch_counts() != {counter: 1}:
            raise AssertionError(f"{name}: launches {ops.launch_counts()}, expected one "
                                 f"{counter}")
        want = grads(plain, inputs)
        err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(got, want))
        if not err <= GRAD_RTOL:
            raise AssertionError(f"{name}: gradients differ from the plain version's by "
                                 f"{err:.3g} of their max (tolerance {GRAD_RTOL})")
        log(f"  grad hold {name}: max error {err:.3g} of each tensor's max")
        return err

    out = {}
    H, P, N = 32, 64, 128
    for t in (1, 6, 16):
        args = (rand(4, t, H, P), rand(4, t, N), rand(4, t, N),
                softplus(rand(4, t, H) - 4.0), torch.linspace(1.0, 16.0, H, device=dev),
                rand(4, H, P, N) * 0.5)
        out[f"ssd_update_t{t}"] = hold(f"ssd_update T {t}",
                                       lambda *a: ssd_update(*a, False),
                                       lambda *a: ssd_update_ref(*a, False), args,
                                       "ssd_update")
    for name, (hq, hkv, sa, dh) in {"whisper": (12, 12, 1500, 64),
                                    "vision": (64, 8, 1600, 128)}.items():
        q, k, v = rand(2, 32, hq, dh), rand(2, sa, hkv, dh), rand(2, sa, hkv, dh)
        qpos = torch.full((2, 32), sa - 1, dtype=torch.int32, device=dev)
        out[f"cross_{name}"] = hold(f"cross read {name}", flash_decode_cross,
                                    lambda q, k, v: flash_decode_ref(q, k, v, qpos),
                                    (q, k, v), "flash_decode_cross")
    x = rand(4, 64).requires_grad_(True)
    try:
        smooth_quant(x, torch.ones(64, device=dev))
    except RuntimeError as exc:
        if "no backward" not in str(exc):
            raise
    else:
        raise AssertionError("smooth_quant took an input that needs a gradient")
    return out


def train_kernel_rows(torch, dev, flush) -> dict:
    """Every kernel of smollm-135m's served W8A8 path at its full-width
    shapes, against its plain version (mamba2-370m's are the SSM phase's
    rows): ``flash_decode`` at 9/3 heads of 64 (G 3), the chain window and
    the vanilla one, over the cache the served run allocates, the window
    at the middle of the new tokens; ``int8_matmul`` at q/o (576 → 576),
    k/v (576 → 192), gate/up (576 → 1536), down (1536 → 576) and the tied
    ``lm_head`` (576 → 49152) at the chain window's rows (24), gate/up at
    the vanilla window's (4) and at the prefill's (4 × 191);
    ``norm_smooth_quant`` at d 576 with 3 readers (q/k/v), 2 (gate/up) and
    1 (the final norm before ``lm_head``); ``smooth_quant`` at the o and
    down inputs (576, 1536)."""
    from repro_torch.configs import get_config

    g = torch.Generator(device=dev).manual_seed(22)
    cfg = get_config("smollm-135m")
    D, FF, V, KV = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.kv_dim
    M = B * (GAMMA + 1)
    S = -(-(TRAIN_PROMPT + TRAIN_NEW + GAMMA + 2) // 128) * 128      # transformer.init_cache
    tag = dict(phase="train", arch=cfg.name)
    out = {"flash_decode_g3_dh64": flash_chain_rows(
        torch, dev, g, flush, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, S, False,
        pos=TRAIN_PROMPT + TRAIN_NEW // 2, **tag)}
    out["int8_matmul"] = int8_matmul_rows(
        torch, dev, g, flush,
        ((M, D, cfg.q_dim), (M, D, KV), (M, D, FF), (M, FF, D), (M, D, V), (B, D, FF),
         (B * (TRAIN_PROMPT - 1), D, FF)), **tag)
    out["norm_smooth_quant"] = [r for readers in (3, 2, 1) for r in norm_smooth_quant_rows(
        torch, dev, g, flush, (B, M), D, readers, cfg.norm_eps, **tag)]
    out["smooth_quant"] = smooth_quant_rows(torch, dev, g, flush, ((M, cfg.q_dim), (M, FF)),
                                            **tag)
    for name, rows in out.items():
        for r in rows:
            log(f"  {name:22s} {str(r['shape']):32s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']}")
    return out


def train_breakdown(torch, run, cfg, batch) -> dict:
    """Where a train step's time goes (``run``: the train CLI's
    ``TrainRun``).  Each part run eagerly and timed alone with CUDA events
    (median of 3, after one warm-up; eager, the host sets the pace): the
    forward (loss under no_grad, no remat), the forward and backward with
    per-layer remat (``value_and_grad``), the optimizer update
    (``adamw_update``, its result dropped), and, for a tied embedding, the
    tied logits' product forward and backward at the step's rows (one GEMM
    in training).  Then torch.profiler over one eager step (its device busy
    ms, wall and idle share) and over one replay of the run's captured step
    (``run.step``, a ``CapturedTrainStep``): its device busy ms and top
    kernels, its profiled wall, and its idle share against the run's
    unprofiled median step.  The replay is a real step: it trains the
    model one step further."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import tied_logits
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.trainer import loss_fn, train_leaves, value_and_grad

    params, opt_cfg, opt = run.params, run.opt_cfg, run.opt_state
    dev = params.embed.w.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)

    def ev_ms(fn) -> float:
        fn()
        times = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def fwd():
        with torch.no_grad():
            loss_fn(params, cfg, tokens, labels)

    holder = {}

    def fwd_bwd():
        holder["grads"] = value_and_grad(params, cfg, batch, remat=True)[1]

    out = dict(forward_ms=ev_ms(fwd), forward_backward_remat_ms=ev_ms(fwd_bwd))
    leaves = train_leaves(params)
    out["optimizer_ms"] = ev_ms(lambda: adamw_update(opt_cfg, leaves, holder["grads"], opt))
    if cfg.tie_embeddings:
        w = params.embed.w.detach().requires_grad_(True)
        x = torch.randn(tokens.numel(), cfg.d_model, device=dev,
                        dtype=cfg.dtype).requires_grad_(True)

        def logits():
            with torch.enable_grad():
                torch.autograd.grad(tied_logits(x, w).sum(), (x, w))

        out["tied_logits_fwd_bwd_ms"] = ev_ms(logits)
    del holder
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = value_and_grad(params, cfg, batch, remat=True)
        adamw_update(opt_cfg, leaves, grads, opt)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = device_time(torch, prof)[0]
    del grads
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step(params, opt, batch)
        torch.cuda.synchronize()
        replay_wall_ms = 1e3 * (time.perf_counter() - t0)
    replay_busy, top = device_time(torch, prof)[:2]
    out.update(profiled_eager_step_ms=wall_ms, eager_device_busy_ms=busy,
               eager_idle_share=(1 - busy / wall_ms) if busy else None,
               graph_step_ms=run.step_ms, profiled_replay_ms=replay_wall_ms,
               replay_device_busy_ms=replay_busy,
               graph_idle_share=(1 - replay_busy / run.step_ms) if replay_busy else None,
               replay_top_kernels_ms=top)
    return out


def train_phase(torch, dev, smi: str, flush) -> tuple:
    """Training on the card through the port's train CLI
    (``launch/train.py``), then serving what it trained.  First the
    gradient holds (:func:`train_grad_holds`) and the served path's
    kernels at smollm-135m's shapes (:func:`train_kernel_rows`).  Then for
    each of TRAIN_RUNS' models at full width and depth, bf16 weights from
    the CLI's seed (the serve CLI's too), f32 moments: ``train.main`` with
    its steps, batch, sequence length, peak lr and warm-up (cosine to 0,
    clip 1.0, per-layer remat) on ``lm_batches(seed=0,
    markov_alpha=TRAIN_ALPHA)``, each step a CUDA graph and timed on the
    host clock after a synchronize, saving the ``.npz`` (``--ckpt``, the
    reference's format).  Gates: every loss finite; the mean of the last
    10 at least TRAIN_DROP nat under step 1's.  Records the median step ms
    after the warm-up, training tokens/s, peak memory, the largest
    gradient norm (before the clip), the loss curve every TRAIN_LOG_EVERY
    steps and the step's breakdown (:func:`train_breakdown`).  The
    checkpoint is loaded back: every leaf bit-equal to the trained
    model's.  Then ``serve.main`` with ``--ckpt`` serves it: W8A8 with the
    ngram drafter (γ 5) and with the vanilla drafter, batch 4, gsm8k-preset
    prompts of TRAIN_PROMPT tokens from the training chain
    (``task_prompts``' successor table is ``lm_batches(seed=0)``'s),
    TRAIN_NEW new tokens, greedy, through graphs, launch counters zeroed
    before each run; and, beside them, the spec run on the random init.
    Gates: spec ≡ vanilla token for token, no non-finite row, and every
    kernel of the served path launched.  Returns (info, runs, kernel
    rows)."""
    import tempfile

    import numpy as np

    from repro_torch.bridge import from_jax_params
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.train.checkpoint import load_checkpoint
    from repro_torch.train.trainer import train_leaves

    info = dict(card=smi, grad_holds=train_grad_holds(torch, dev))
    kern = train_kernel_rows(torch, dev, flush)
    runs = {}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    for arch, (steps, batch_rows, seq, lr, warmup) in TRAIN_RUNS.items():
        t_arch = time.perf_counter()
        tag = arch.split("-")[0]
        cfg = get_config(arch)
        path = f"{ckpt_dir}/{tag}.npz"
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run = train.main(["--arch", arch, "--steps", str(steps), "--batch", str(batch_rows),
                          "--seq-len", str(seq), "--lr", str(lr), "--warmup", str(warmup),
                          "--markov-alpha", str(TRAIN_ALPHA), "--ckpt", path])
        train_s = time.perf_counter() - t0
        losses = torch.tensor(run.losses)
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{arch}: non-finite training loss")
        first, last10 = run.losses[0], run.last10
        if not last10 <= first - TRAIN_DROP:
            raise AssertionError(f"{arch}: the loss fell from {first:.4f} to {last10:.4f} "
                                 f"(last 10), less than {TRAIN_DROP} nat")
        tinfo = dict(arch=arch, num_layers=cfg.num_layers, steps=steps, batch=batch_rows,
                     seq_len=seq, lr=lr, warmup=warmup, first_loss=first, last10_loss=last10,
                     loss_curve=[[i + 1, run.losses[i]] for i in range(steps)
                                 if (i + 1) % TRAIN_LOG_EVERY == 0 or i == 0],
                     max_grad_norm=max(run.grad_norms),
                     grad_norm_curve=[[i + 1, run.grad_norms[i]] for i in range(steps)
                                      if (i + 1) % TRAIN_LOG_EVERY == 0 or i == 0],
                     step_ms=run.step_ms, first_step_ms=1e3 * run.step_s[0],
                     train_tok_s=batch_rows * seq / (run.step_ms / 1e3),
                     train_s=sum(run.step_s), cli_s=train_s, peak_mem_gb=run.peak_gb,
                     params_gb=sum(t.numel() * t.element_size()
                                   for t in run.params.buffers()) / 1e9)

        t0 = time.perf_counter()
        back = from_jax_params(load_checkpoint(path)["params"], cfg, device=dev)
        want, got = train_leaves(run.params), train_leaves(back)
        if list(want) != list(got) or not all(
                got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"{arch}: the checkpoint does not give back its leaves")
        tinfo["checkpoint_load_s"] = time.perf_counter() - t0
        del back, want, got
        data = lm_batches(batch_rows, seq, cfg.vocab_size, seed=1, markov_alpha=TRAIN_ALPHA)
        tinfo["breakdown"] = train_breakdown(torch, run, cfg, next(data))
        log(f"  {tag}: trained {steps} steps, loss {first:.4f} -> {last10:.4f} (last 10), "
            f"largest gradient norm {tinfo['max_grad_norm']:.2f}, step "
            f"{tinfo['step_ms']:.1f} ms, {tinfo['train_tok_s']:.0f} tokens/s, peak "
            f"{tinfo['peak_mem_gb']:.2f} GB; {json.dumps(tinfo['breakdown'])} ({smi})")
        del run
        gc.collect()
        torch.cuda.empty_cache()

        need = ("norm_smooth_quant", "int8_matmul") + (
            ("ssd_update",) if cfg.arch_type == "ssm" else ("flash_decode",))
        base = ["--arch", arch, "--verifier", "w8a8", "--gamma", str(GAMMA), "--batch", str(B),
                "--prompt-len", str(TRAIN_PROMPT), "--new-tokens", str(TRAIN_NEW)]
        served = {}
        for name, flags in ((f"{tag}_trained_spec_w8a8", ["--ckpt", path, "--drafter", "ngram"]),
                            (f"{tag}_trained_vanilla_w8a8", ["--ckpt", path,
                                                             "--drafter", "vanilla"]),
                            (f"{tag}_random_spec_w8a8", ["--drafter", "ngram"])):
            gc.collect()
            ops.reset_launch_counts()
            r = serve.main(base + flags)
            torch.cuda.synchronize()
            rec = dict(launches=ops.launch_counts(), L=r.mean_accept_len, tok_s=r.tokens_per_s,
                       steps=r.steps, new_tokens=r.new_tokens, bad_rows=int(r.bad.sum()),
                       capture_ms=1e3 * r.capture_s, card=smi)
            missing = [k for k in need if rec["launches"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
            if rec["bad_rows"] or r.new_tokens != B * TRAIN_NEW:
                raise AssertionError(f"{name}: {rec['bad_rows']} non-finite rows, "
                                     f"{r.new_tokens} new tokens")
            served[name] = r.tokens[:, :TRAIN_PROMPT + TRAIN_NEW].cpu()
            runs[name] = rec
            log(f"  {name}: L={rec['L']:.3f} steps={rec['steps']} tok/s={rec['tok_s']:.1f} "
                f"launches={rec['launches']} ({smi})")
            del r
        spec, vanilla = served[f"{tag}_trained_spec_w8a8"], served[f"{tag}_trained_vanilla_w8a8"]
        if not torch.equal(spec, vanilla):
            share = (spec == vanilla).float().mean().item()
            raise AssertionError(f"{arch}: greedy spec tokens differ from vanilla's "
                                 f"({share:.4f} shared)")
        gen = spec[:, TRAIN_PROMPT:].numpy()
        tinfo.update(L_trained=runs[f"{tag}_trained_spec_w8a8"]["L"],
                     L_random=runs[f"{tag}_random_spec_w8a8"]["L"],
                     distinct_new_tokens_per_row=float(np.mean([len(set(row)) for row in gen])),
                     phase_s=time.perf_counter() - t_arch)
        os.remove(path)
        info[tag] = tinfo
    os.rmdir(ckpt_dir)
    return info, runs, kern


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_phase(torch, dev, smi: str) -> tuple:
    """The launch tooling (``repro_torch/launch``) and the ported example,
    (a)-(e) of the module docstring.  Returns (info, runs)."""
    import tempfile

    from repro_torch.bridge import to_tree
    from repro_torch.configs import REGISTRY, get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline, serve, shapes
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint

    info, runs = {}, {}
    # (a) the dry-run of every arch × shape, one card and four
    t0 = time.perf_counter()
    info["dryrun"] = {}
    for cards in LAUNCH_CARDS:
        rows, failures = dryrun.run(list(REGISTRY), list(shapes.SHAPES), cards, log=log)
        if failures:
            raise AssertionError(f"dry-run on {cards} card(s): {failures}")
        if len(rows) != len(REGISTRY) * len(shapes.SHAPES) or \
                any(r["status"] != "ok" for r in rows):
            raise AssertionError(f"dry-run on {cards} card(s): {len(rows)} rows, not every "
                                 "arch × shape ok")
        info["dryrun"][f"1x{cards}"] = rows
        log(f"  dry-run 1x{cards}: {len(rows)} ok, "
            f"{sum(r['fits_card'] for r in rows)} fit one card")
    info["dryrun_s"] = time.perf_counter() - t0

    # (b) the 7B W8A8 chain step: its bound, and the resident bytes predicted
    cfg = get_config(ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model = Model(cfg, device=dev)
    engine = SpecEngine(model, SpecConfig(gamma=GAMMA, drafter="ngram", verifier="w8a8"))
    raw = model.init_params(torch.Generator(device=dev).manual_seed(0))
    params = engine.prepare_params(raw)          # raw kept, as the server's fallback lane does
    prompts = torch.as_tensor(task_prompts("gsm8k", B, PROMPT, cfg.vocab_size),
                              device=dev, dtype=torch.int32)
    pred = dryrun.serve_resident_bytes(cfg, "w8a8", B, PROMPT + NEW + GAMMA + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        r = engine.generate(params, prompts, NEW)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated(dev) - base
    resident = torch.cuda.memory_allocated(dev) - base      # after: no prefill transients
    if bool(r.bad.any()) or r.new_tokens != B * NEW:
        raise AssertionError(f"7B step run: {int(r.bad.sum())} non-finite rows, "
                             f"{r.new_tokens} new tokens")
    mem_err = measured / pred["resident_bytes"] - 1
    window = step_window(torch, engine, params, prompts)
    context = PROMPT + NEW // 2
    bms, by = roofline.step_bound_ms(cfg, "w8a8", "bf16", B, context, GAMMA + 1)
    busy, step = window["device_busy_ms_per_step"], window["step_ms"]
    info["step"] = dict(
        arch=ARCH, verifier="w8a8", drafter="ngram", batch=B, context=context,
        window_tokens=GAMMA + 1,
        step_bound_ms=bms, bound_by=by, device_busy_ms_per_step=busy, graph_step_ms=step,
        bound_share_of_busy=bms / busy if busy else None, bound_share_of_step=bms / step,
        L=r.mean_accept_len, predicted=pred, measured_peak_bytes=measured,
        resident_after_bytes=resident,
        mem_rel_err=mem_err, step_window=window, card=smi)
    log(f"  7B W8A8 chain step (B {B}, context {context}, window {GAMMA + 1}): step_bound_ms "
        f"{bms:.4f} ({by}); device busy {busy:.3f} ms/step, share {bms / busy:.3f}; graph "
        f"step {step:.3f} ms, share {bms / step:.3f} ({smi})")
    log(f"  resident bytes: predicted {pred['resident_bytes'] / 1e9:.3f} GB (raw "
        f"{pred['raw_bytes'] / 1e9:.3f} + prepared {pred['prepared_new_bytes'] / 1e9:.3f} + "
        f"state {pred['state_bytes'] / 1e9:.3f}), measured peak {measured / 1e9:.3f} GB "
        f"over the generate run ({100 * mem_err:+.2f}%), {resident / 1e9:.3f} GB held after it")
    if abs(mem_err) > MEM_TOL:
        raise AssertionError(f"resident bytes: measured {measured} vs predicted "
                             f"{pred['resident_bytes']} ({100 * mem_err:+.2f}%)")
    del model, engine, raw, params, r
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the quickstart at smollm-135m's full width
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    qs = load_example("quickstart").main(["--full"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    missing = [group for group in QUICKSTART_NEEDS if not any(counts.get(k, 0) for k in group)]
    if not qs["lossless"] or missing:
        raise AssertionError(f"quickstart: lossless {qs['lossless']}, never launched {missing}")
    runs["quickstart_full"] = dict(launches=counts, L=qs["L"], steps=qs["steps"],
                                   vanilla_steps=qs["vanilla_steps"],
                                   run_s=time.perf_counter() - t0, card=smi)
    log(f"  quickstart --full: lossless, L={qs['L']:.3f}, steps {qs['steps']} (vanilla "
        f"{qs['vanilla_steps']}), launches {counts}")

    # (d) the serve CLI's --mode, --task and --attn-impl at 7B
    base_argv = ["--arch", ARCH, "--batch", str(B), "--prompt-len", str(PROMPT),
                 "--new-tokens", str(NEW)]
    toks = {}
    for name, flags in (("cli_mode_spec", ["--mode", "spec"]),
                        ("cli_drafter_ngram", ["--drafter", "ngram"]),
                        ("cli_humaneval_pallas", ["--mode", "spec", "--task", "humaneval",
                                                  "--attn-impl", "pallas"])):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        r = serve.main(base_argv + flags)
        torch.cuda.synchronize()
        rec = dict(flags=flags, launches=ops.launch_counts(), L=r.mean_accept_len,
                   steps=r.steps, tok_s=r.tokens_per_s, bad_rows=int(r.bad.sum()), card=smi)
        missing = [k for k in ("norm_smooth_quant", "int8_matmul", "flash_decode")
                   if rec["launches"].get(k, 0) <= 0]
        if missing or rec["bad_rows"] or r.new_tokens != B * NEW:
            raise AssertionError(f"{name}: never launched {missing}, {rec['bad_rows']} "
                                 f"non-finite rows, {r.new_tokens} new tokens")
        toks[name] = r.tokens[:, :PROMPT + NEW].cpu()
        runs[name] = rec
        log(f"  {name}: L={rec['L']:.3f} steps={rec['steps']} tok/s={rec['tok_s']:.1f}")
        del r
    if not torch.equal(toks["cli_mode_spec"], toks["cli_drafter_ngram"]):
        raise AssertionError("--mode spec gives other tokens than --drafter ngram")

    # (e) the trained smollm in the scan layout through --ckpt
    cfg = get_config("smollm-135m")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    served = {}
    for layout in ("loop", "scan"):
        path = f"{ckpt_dir}/{layout}.npz"
        tree = (Model(cfg, device=dev).to_scan(qs["params"]) if layout == "scan"
                else to_tree(qs["params"]))
        save_checkpoint(path, {"params": tree, "step": 120})
        if ("scan" in load_checkpoint(path)["params"]) != (layout == "scan"):
            raise AssertionError(f"the {layout} checkpoint holds the wrong layout")
        r = serve.main(["--arch", "smollm-135m", "--ckpt", path, "--verifier", "w8a8",
                        "--batch", str(B), "--prompt-len", str(TRAIN_PROMPT),
                        "--new-tokens", str(TRAIN_NEW)])
        served[layout] = r.tokens[:, :TRAIN_PROMPT + TRAIN_NEW].cpu()
        os.remove(path)
        del r, tree
    os.rmdir(ckpt_dir)
    if not torch.equal(served["scan"], served["loop"]):
        raise AssertionError("the scan-layout checkpoint serves other tokens than the loop's")
    info["scan_ckpt_tokens_equal"] = True
    log("  smollm trained: the scan-layout checkpoint serves the loop layout's tokens")
    del qs
    gc.collect()
    torch.cuda.empty_cache()
    return info, runs


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
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {device_name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(smi)

    t0 = time.perf_counter()
    reports = ops.build()
    log(f"build: {time.perf_counter() - t0:.1f}s for {sorted(reports) or 'cached libraries'}")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "spill", "arning", "serialized")):
                log(f"  {src}: {line.strip()}")

    if sys.argv[1:] == ["--launch-only"]:      # the launch phase alone, for its own runs
        log("launch phase")
        t0 = time.perf_counter()
        launch_out, launch_runs = launch_phase(torch, dev, smi)
        launch_out["phase_s"] = time.perf_counter() - t0
        log(f"  launch phase: {launch_out['phase_s']:.1f} s")
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_launch.json").write_text(json.dumps(
            dict(launch=launch_out, runs=launch_runs), indent=1))
        return 0
    if sys.argv[1:] == ["--ring-only"]:        # the ring phase alone, for its own runs
        log("ring phase")
        flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
        _, raw7, prepared7 = seven_b(torch, dev)
        ring_out, ring_kern, ring_runs = ring_phase(torch, dev, flush, raw7, prepared7["w8a8"])
        log(f"  ring phase: {ring_out['phase_s']:.1f} s")
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_ring.json").write_text(json.dumps(
            dict(ring=ring_out, kernels=ring_kern, runs=ring_runs), indent=1))
        return 0
    if sys.argv[1:] == ["--train-only"]:       # the train phase alone, for its own runs
        log("train phase")
        t0 = time.perf_counter()
        flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
        train_out, _, train_kern = train_phase(torch, dev, smi, flush)
        log(f"  train phase: {time.perf_counter() - t0:.1f} s")
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_train.json").write_text(json.dumps(
            dict(train=train_out, kernels=train_kern), indent=1))
        return 0
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
        # the profiler slows the host; the idle share is against the window's
        # unprofiled step
        if p["device_busy_ms_per_step"]:
            log(f"  {run}: device busy {p['device_busy_ms_per_step']:.2f} ms/step; "
                f"unprofiled step {p['step_ms']:.2f} ms; idle "
                f"{p['device_idle_share_profiled']:.3f} under the profiler, "
                f"{p['device_idle_share']:.3f} of the unprofiled step; launches per step "
                f"{p['launches_per_step']}; device kernels per step "
                f"{p['device_kernels_per_step']:.1f}")
        nsq = kern["norm_smooth_quant"][1]
        log(f"  {run}: in the graph, ms per launch {p['in_graph_ms_per_launch']} "
            f"(norm_smooth_quant flushed bench {nsq['ms']:.4f} ms at {nsq['shape']})")
    log("graph phase")
    model7, raw7, prepared7 = seven_b(torch, dev)
    graph = graph_phase(torch, dev, model7, prepared7)
    log("ring phase")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    ring_out, ring_kern, ring_runs = ring_phase(torch, dev, flush, raw7, prepared7["w8a8"])
    del flush, model7, raw7, prepared7
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  ring phase: {ring_out['phase_s']:.1f} s")
    kern.update(ring_kern)
    runs.update(ring_runs)
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
    log("paged phase: lossless gate")
    preempt = paged_lossless_gate(torch, dev)
    log("server phase")
    server = server_phase(torch, dev)
    runs["server_s1"] = server["s1"]
    log("MoE phase")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    moe_out, moe_kern = moe_phase(torch, dev, flush)
    del flush
    for kname, rows in moe_kern.items():        # the MoE phase's rows after the 7B ones
        kern.setdefault(kname, []).extend(rows)
    runs.update(moe_out.pop("runs"))
    log("SSM phase")
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    ssm_out, ssm_kern = ssm_phase(torch, dev, flush)
    del flush
    ssm_out["phase_s"] = time.perf_counter() - t0
    log(f"  SSM phase: {ssm_out['phase_s']:.1f} s")
    for kname, rows in ssm_kern.items():        # the SSM phase's rows after the others
        kern.setdefault(kname, []).extend(rows)
    runs.update(ssm_out.pop("runs"))
    log("families phase")
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    fam_out, fam_kern = families_phase(torch, dev, flush)
    del flush
    fam_out["phase_s"] = time.perf_counter() - t0
    log(f"  families phase: {fam_out['phase_s']:.1f} s")
    for kname, rows in fam_kern.items():        # the families' rows after the others
        kern.setdefault(kname, []).extend(rows)
    runs.update(fam_out.pop("runs"))
    log("train phase")
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    train_out, train_runs, train_kern = train_phase(torch, dev, smi, flush)
    del flush
    train_out["phase_s"] = time.perf_counter() - t0
    log(f"  train phase: {train_out['phase_s']:.1f} s")
    for kname, rows in train_kern.items():       # the train phase's rows after the others
        kern.setdefault(kname, []).extend(rows)
    runs.update(train_runs)
    log("launch phase")
    t0 = time.perf_counter()
    launch_out, launch_runs = launch_phase(torch, dev, smi)
    launch_out["phase_s"] = time.perf_counter() - t0
    log(f"  launch phase: {launch_out['phase_s']:.1f} s")
    runs.update(launch_runs)

    meta = {
        "smooth_quant": ("src/repro_torch/csrc/smooth_quant.cu",
                         "src/repro/kernels/smooth_quant.py:24", "spec_w8a8_kv_bf16"),
        "norm_smooth_quant": ("src/repro_torch/csrc/smooth_quant.cu",
                              "src/repro/kernels/smooth_quant.py:24", "spec_w8a8_kv_bf16"),
        "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                        "src/repro/kernels/int8_matmul.py:26", "spec_w8a8_kv_bf16"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:117", "spec_w8a8_kv_bf16"),
        "flash_decode_int8": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:134", "spec_w8a8_kv_int8"),
        "int4_matmul": ("src/repro_torch/csrc/int4_matmul.cu",
                        "src/repro/kernels/int4_matmul.py:29", "spec_w4a8_kv_bf16"),
        # not a TPU kernel: the reference reads a ring through a jnp attend;
        # the port reads it through flash_decode for row invariance
        "flash_decode_ring": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/models/attention.py:242", "ring_spec_w8a8_kv_bf16"),
        "flash_decode_ring_int8": ("src/repro_torch/csrc/flash_decode.cu",
                                   "src/repro/models/attention.py:242",
                                   "ring_spec_w8a8_kv_int8"),
        "flash_decode_tree": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:125", "tree_w8a8_kv_bf16"),
        "flash_decode_tree_int8": ("src/repro_torch/csrc/flash_decode.cu",
                                   "src/repro/kernels/flash_decode.py:143",
                                   "tree_w4a8_kv_int8"),
        **{name: ("src/repro_torch/csrc/flash_decode.cu",
                  "src/repro/kernels/flash_decode.py:273", run)
           for run, (_, _, name) in PAGED_RUNS.items()},
        # not a TPU kernel: the reference's expert product is a jnp dot_general
        "int8_matmul_batched": ("src/repro_torch/csrc/int8_batched.cu",
                                "src/repro/models/moe.py:72", "moe_spec_w8a8"),
        # not a TPU kernel: the reference's SSD recurrence is a lax.scan
        "ssd_update": ("src/repro_torch/csrc/ssd_update.cu", "src/repro/models/ssm.py:89",
                       "zamba2_spec_w8a8"),
        # zamba2's shared attention, head size 80 (counted as flash_decode[_int8])
        "flash_decode_dh80": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/kernels/flash_decode.py:117", "zamba2_spec_w8a8"),
        "flash_decode_int8_dh80": ("src/repro_torch/csrc/flash_decode.cu",
                                   "src/repro/kernels/flash_decode.py:134",
                                   "zamba2_spec_w8a8_kv_int8"),
        # stablelm-12b, head size 160; codeqwen's MHA at 32 KV heads (G = 1)
        "flash_decode_dh160": ("src/repro_torch/csrc/flash_decode.cu",
                               "src/repro/kernels/flash_decode.py:117", "stablelm_spec_w8a8"),
        "flash_decode_int8_dh160": ("src/repro_torch/csrc/flash_decode.cu",
                                    "src/repro/kernels/flash_decode.py:134",
                                    "stablelm_spec_w8a8_kv_int8"),
        "flash_decode_tree_dh160": ("src/repro_torch/csrc/flash_decode.cu",
                                    "src/repro/kernels/flash_decode.py:125",
                                    "stablelm_tree_w8a8"),
        "flash_decode_tree_int8_dh160": ("src/repro_torch/csrc/flash_decode.cu",
                                         "src/repro/kernels/flash_decode.py:143",
                                         "stablelm_tree_w8a8_kv_int8"),
        "flash_decode_paged_dh160": ("src/repro_torch/csrc/flash_decode.cu",
                                     "src/repro/kernels/flash_decode.py:273",
                                     "stablelm_paged_w8a8"),
        "flash_decode_g1_kv32": ("src/repro_torch/csrc/flash_decode.cu",
                                 "src/repro/kernels/flash_decode.py:117", "codeqwen_spec_w8a8"),
        # not a TPU kernel: the reference's cross-attention is a jnp attend;
        # the port reads ck/cv through flash_decode for row invariance
        "flash_decode_cross": ("src/repro_torch/csrc/flash_decode.cu",
                               "src/repro/models/attention.py:459", "vision_spec_w8a8"),
        # smollm-135m served from its trained checkpoint: 9/3 heads of 64 (G 3)
        "flash_decode_g3_dh64": ("src/repro_torch/csrc/flash_decode.cu",
                                 "src/repro/kernels/flash_decode.py:117",
                                 "smollm_trained_spec_w8a8"),
    }
    counter = {"flash_decode_dh80": "flash_decode", "flash_decode_int8_dh80": "flash_decode_int8",
               "flash_decode_dh160": "flash_decode", "flash_decode_int8_dh160": "flash_decode_int8",
               "flash_decode_tree_dh160": "flash_decode_tree",
               "flash_decode_tree_int8_dh160": "flash_decode_tree_int8",
               "flash_decode_paged_dh160": "flash_decode_paged",
               "flash_decode_g1_kv32": "flash_decode", "flash_decode_g3_dh64": "flash_decode"}
    # the representative main-path shape of each kernel in the summary line
    pick = {"smooth_quant": 0, "norm_smooth_quant": 1, "int8_matmul": 2, "flash_decode": 0, "flash_decode_int8": 0,
            "int4_matmul": 2, "flash_decode_tree": 0, "flash_decode_tree_int8": 0,
            "int8_matmul_batched": 2,                              # up/gate, chain C 3
            "ssd_update": 0, "flash_decode_dh80": 0, "flash_decode_int8_dh80": 0,   # zamba2 chain
            "flash_decode_dh160": 0, "flash_decode_int8_dh160": 0, "flash_decode_tree_dh160": 0,
            "flash_decode_tree_int8_dh160": 0, "flash_decode_paged_dh160": 0,
            "flash_decode_g1_kv32": 0, "flash_decode_cross": 0,     # chain window, vision
            "flash_decode_g3_dh64": 0,                              # chain window, smollm
            "flash_decode_ring": 0, "flash_decode_ring_int8": 0,    # 7B chain window, ring
            **{name: 0 for (_, _, name) in PAGED_RUNS.values()}}   # paged: bs 128
    kernels = []
    for kname, (source, replaces, run) in meta.items():
        row = kern[kname][pick[kname]]
        key = counter.get(kname, kname)
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=runs[run]["launches"].get(key, 0),
            max_abs_err=max(r["max_abs_err"] for r in kern[kname]),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"], shape=row["shape"],
            host_ms=row["host_ms"],
            **{k: row[k] for k in ("yardstick_contiguous_ms", "yardstick_int8_matmul_ms",
                                   "yardstick_bmm_bf16_ms")
               if k in row},
            launches_by_run={k: v["launches"].get(key, 0) for k, v in runs.items()
                             if isinstance(v, dict) and "launches" in v}))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(device=device_name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             kernels=kern, runs=runs, profile=prof, prefix_sharing=sched["prefix_sharing"],
             profile_paged=sched["profile_paged_w8a8_kv_bf16"], preemption=preempt,
             graph=graph, ring=ring_out, server=server, moe=moe_out, ssm=ssm_out, families=fam_out,
             train=train_out, launch=launch_out),
        indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
