"""Greedy tokens of speculative and vanilla decoding side by side on the card.

    python3 tools/spec_vs_vanilla.py [--src DIR] [--prompt-len N]

Runs the port's serve CLI twice on ``quasar-paper-7b`` (seeded random
weights, batch 4, 64 new tokens, W8A8 verifier, bf16 KV cache, greedy):
once with the ngram drafter (γ 5), once with the vanilla drafter.  Greedy
speculative decoding is lossless, so the two should commit the same
tokens; prints the share of tokens they have in common and, per row, the
first step where they differ (64: none).  ``--src`` imports ``repro_torch``
from another tree (e.g. a `git archive` of the parent), so one call can
compare two trees.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NEW = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--prompt-len", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("spec_vs_vanilla: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.launch import serve

    toks = {}
    for drafter in ("ngram", "vanilla"):
        r = serve.main(["--arch", "quasar-paper-7b", "--batch", "4", "--prompt-len",
                        str(args.prompt_len), "--new-tokens", str(NEW), "--verifier", "w8a8",
                        "--kv-cache", "bf16", "--drafter", drafter, "--gamma", "5"])
        toks[drafter] = r.tokens[:, args.prompt_len:args.prompt_len + NEW].cpu()
    a, b = toks["ngram"], toks["vanilla"]
    first = [int((a[i] != b[i]).nonzero()[0]) if (a[i] != b[i]).any() else NEW
             for i in range(a.shape[0])]
    print(f"{args.src} prompt {args.prompt_len}: shared {(a == b).float().mean().item():.4f}, "
          f"first difference per row {first}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
