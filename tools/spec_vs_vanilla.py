"""Greedy tokens of speculative and vanilla decoding side by side on the card.

    python3 tools/spec_vs_vanilla.py [--src DIR] [--prompt-len N] [--verifier V] [--layers]

Runs the port's serve CLI twice on ``quasar-paper-7b`` (seeded random
weights, batch 4, 64 new tokens, the W8A8 verifier or ``--verifier``
w4a8 / bf16, bf16 KV cache, greedy):
once with the ngram drafter (γ 5), once with the vanilla drafter.  Greedy
speculative decoding is lossless, so the two should commit the same
tokens; prints the share of tokens they have in common and, per row, the
first step where they differ (64: none).  ``--src`` imports ``repro_torch``
from another tree (e.g. a `git archive` of the parent), so one call can
compare two trees.  Needs a CUDA card.

``--layers`` then localises a difference.  It first holds the RMSNorm,
and torch's f32 row mean beside it, alone: rows of 4-row calls (vanilla's
M) against the same rows in 24- and 88-row calls (the chain and tree
windows), and the host time per call of the norm with the port's folded
mean and with torch's.  Then it prefills the same
weights with the prompt and vanilla's tokens, and at every position from
the prompt's last token to the one whose logits gave the first differing
token (the prompt's last alone when none differs) copies the cache twice
and runs the verify forward once as vanilla does (T = 1, M = B rows) and
once as the spec window does (T = γ+1, M = B·(γ+1) rows, the next vanilla
tokens as drafts).  Window row 0 sees the same cache and token as the
T = 1 row, so every op's output for it must be bit-equal.  Forward hooks on every module
(norms, attention, FFN, each W8A8 linear, the decoder blocks) and wrappers
around ``smooth_quant`` and ``norm_smooth_quant`` (codes and Δx),
``int8_matmul``, ``int4_matmul``, ``apply_rope`` and
the attention read record row 0 of each op in call order, plus the K/V the
window wrote at that slot and the logits; prints the first op whose bits
differ at the earliest such position (or "none found"), and which op
differed first at each position.
"""
from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "quasar-paper-7b"
NEW = 64
GAMMA = 5
B = 4


def _rows(t, T):
    """Row 0 of each batch row's window: (B, T, ...) → [:, 0]; a 2-D
    kernel operand (B·T, ...) → rows 0, T, 2T, …"""
    if t.dim() >= 2 and t.shape[0] == B and t.shape[1] == T:
        return t[:, 0]
    if t.shape[0] == B * T:
        return t[::T]
    return t


def _record(torch, model, params, cache, window, start):
    """Run one verify forward with every op's window-row-0 output recorded."""
    import repro_torch.kernels.int4_matmul as i4
    import repro_torch.kernels.int8_matmul as i8
    import repro_torch.kernels.smooth_quant as sq
    import repro_torch.models.attention as attn

    T = window.shape[1]
    rec, hooks, saved = [], [], {}

    def put(name, t):
        if isinstance(t, tuple):
            t = t[0]
        if torch.is_tensor(t) and (t.is_floating_point() or t.dtype == torch.int8):
            rec.append((name, _rows(t, T).detach().clone()))

    for name, mod in params.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, name=name: put(name, out)))

    def wrap(owner, attr, label):
        fn = getattr(owner, attr)
        saved[(owner, attr)] = fn

        def inner(*a, **kw):
            out = fn(*a, **kw)
            flat = out if isinstance(out, (tuple, list)) else (out,)
            flat = [t for o in flat for t in (o if isinstance(o, tuple) else (o,))]
            for i, o in enumerate(flat):
                put(f"{label}[{i}]", o)
            return out
        setattr(owner, attr, inner)

    wrap(sq, "smooth_quant", "smooth_quant")
    wrap(sq, "norm_smooth_quant", "norm_smooth_quant")
    wrap(i8, "int8_matmul", "int8_matmul")
    wrap(i4, "int4_matmul", "int4_matmul")
    wrap(attn, "apply_rope", "apply_rope")
    wrap(attn, "attend", "attend")
    try:
        with torch.no_grad():
            logits, cache = model.verify_step(params, cache, window, start)
    finally:
        for h in hooks:
            h.remove()
        for (owner, attr), fn in saved.items():
            setattr(owner, attr, fn)
    slot = int(start[0])
    for i, layer in enumerate(cache["layers"]):
        for key in ("k", "v"):
            rec.append((f"cache layer {i} {key}", layer[key][:, slot].clone()))
    rec.append(("logits", logits[:, 0].clone()))
    return rec


def layers(torch, args, vanilla_new, first: int) -> None:
    import collections
    import dataclasses

    import statistics
    import time

    from repro_torch.configs import get_config
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.launch.serve import TASK, WEIGHT_SEED
    from repro_torch.models import Model
    from repro_torch.models.common import rms_norm
    from repro_torch.serving.engine import SpecEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype="bf16")
    norms_per_step = 2 * cfg.num_layers + 1

    # the norm alone: 4-row calls against the same rows in 24- and 88-row
    # calls, over 88 x 40 rows; torch's own f32 row mean beside it
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(40, 88, cfg.d_model, generator=g, device=dev) * 3).to(cfg.dtype)
    scale = torch.rand(cfg.d_model, generator=g, device=dev) + 0.5
    for name, fn in (("rms_norm", lambda t: rms_norm(t, scale)),
                     ("torch's f32 row mean", lambda t: t.float().square().mean(-1))):
        for m in (24, 88):
            diff = sum(int((fn(x[i, :m])[:4] != fn(x[i, :4])).sum()) for i in range(40))
            print(f"layers: {name}, 4-row calls vs the same rows at M = {m}: {diff} of "
                  f"{fn(x[:, :4]).numel()} values differ")

    def torch_mean_norm(t, eps=1e-5):    # rms_norm before the row-invariant fold
        t32 = t.float()
        return (t32 * torch.rsqrt(t32.square().mean(-1, keepdim=True) + eps)
                * scale).to(t.dtype)

    # host cost of the fold: enqueue time per call at the chain window's rows
    # (the card keeps up with these small launches), median of 200 calls
    for name, fn in (("rms_norm (folded mean)", lambda t: rms_norm(t, scale)),
                     ("rms_norm with torch's mean", torch_mean_norm)):
        t = x[0, :B * (GAMMA + 1)]
        fn(t)
        torch.cuda.synchronize()
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn(t)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        ms = statistics.median(host) * 1e3
        print(f"layers: {name} at {tuple(t.shape)}: host {ms:.4f} ms per call, "
              f"{ms * norms_per_step:.3f} ms per step ({norms_per_step} norms)")

    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(WEIGHT_SEED)
    engine = SpecEngine(model, SpecConfig(gamma=GAMMA, drafter="ngram",
                                          verifier=args.verifier))
    params = engine.prepare_params(model.init_params(gen))
    prompts = torch.as_tensor(task_prompts(TASK, B, args.prompt_len, cfg.vocab_size),
                              device=dev, dtype=torch.int32)
    nxt = vanilla_new.to(dev, torch.int32)
    # every position from the prompt's last token to the one whose logits
    # gave the first differing token; later cache slots are masked
    seq = torch.cat([prompts, nxt[:, :first + GAMMA + 1]], dim=1)
    last = args.prompt_len + first - 1
    with torch.no_grad():
        cache = model.prefill(params, model.init_cache(B, seq.shape[1] + GAMMA + 2),
                              seq[:, :last])
    firsts, n_bad = collections.Counter(), 0
    earliest = None
    for q in range(args.prompt_len - 1, last + 1):
        start = torch.full((B,), q, dtype=torch.int32, device=dev)
        window = seq[:, q:q + GAMMA + 1]
        window = torch.cat([window, window.new_zeros(B, GAMMA + 1 - window.shape[1])], 1)
        one = _record(torch, model, params, copy.deepcopy(cache), window[:, :1], start)
        win = _record(torch, model, params, copy.deepcopy(cache), window, start)
        if [n for n, _ in one] != [n for n, _ in win]:
            print("layers: the T = 1 and window forwards ran different ops")
            return
        bad = [(n, a, b) for (n, a), (_, b) in zip(one, win) if not torch.equal(a, b)]
        if bad:
            n_bad += 1
            firsts[bad[0][0]] += 1
            if earliest is None:
                earliest = (q, bad)
    print(f"layers: {last + 2 - args.prompt_len} positions probed "
          f"({args.prompt_len - 1}..{last}), {len(one)} ops each; "
          f"{n_bad} with a differing op")
    if earliest is None:
        print("layers: first differing op: none found")
        return
    q, bad = earliest
    for n, a, b in bad[:6]:
        diff = (a.float() - b.float()).abs()
        print(f"layers: position {q}: differs: {n} shape {tuple(a.shape)} {a.dtype}: "
              f"{int((a != b).sum())} elements, max |diff| {diff.max().item():.3e}")
    print(f"layers: first differing op at each such position: {dict(firsts)}")
    print(f"layers: first differing op: {bad[0][0]} (position {q})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--verifier", choices=("w8a8", "w4a8", "bf16"), default="w8a8")
    ap.add_argument("--layers", action="store_true",
                    help="compare the window's row 0 with the T = 1 row op by op")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("spec_vs_vanilla: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.launch import serve

    toks = {}
    for drafter in ("ngram", "vanilla"):
        r = serve.main(["--arch", ARCH, "--batch", str(B), "--prompt-len",
                        str(args.prompt_len), "--new-tokens", str(NEW), "--verifier",
                        args.verifier,
                        "--kv-cache", "bf16", "--drafter", drafter, "--gamma", str(GAMMA)])
        toks[drafter] = r.tokens[:, args.prompt_len:args.prompt_len + NEW].cpu()
        del r
    a, b = toks["ngram"], toks["vanilla"]
    first = [int((a[i] != b[i]).nonzero()[0]) if (a[i] != b[i]).any() else NEW
             for i in range(a.shape[0])]
    print(f"{args.src} {args.verifier} prompt {args.prompt_len}: shared {(a == b).float().mean().item():.4f}, "
          f"first difference per row {first}")
    if args.layers:
        layers(torch, args, b, min(first) if min(first) < NEW else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
