"""The comparison that decides ``correct``.

Once the window has closed and the program is freed: a sample drawn from
the seed of the requests the run finished, the one with the most served
tokens always in it, until it holds ``SAMPLE_TOKENS`` served tokens or
``SAMPLE_MAX`` requests.  The configuration's plain reference (the file
its ``reference`` names) runs once over each sampled prompt with its
served tokens, and the number compared is the widest gap by which a
served token's reference logit lies below the reference's best at that
position (greedy decoding: every served token is the verifier's argmax
there).

Besides: every request that was running when the window opened has
finished, and in an open loop every request due in the window has its
first token, by the end of the wait after the window (``unanswered``,
limit 0); no request failed (``failed``, limit 0).

The control (:func:`control_gaps`, run by the control test, never by a
benchmark run) puts the program's own next precision down in the
verifier's place, W4A8 for W8A8, and reads at each position the gap of the
token it puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

SAMPLE_TOKENS = 1024
SAMPLE_MAX = 12


def sample(done: Sequence[dict], seed: int) -> List[dict]:
    """Finished requests (dicts with ``prompt`` and ``served``) to compare."""
    if not done:
        return []
    rng = np.random.default_rng((int(seed) % (2 ** 63)) ^ 0x5EED)
    longest = max(range(len(done)), key=lambda i: (len(done[i]["served"]), -i))
    picked, n = [done[longest]], len(done[longest]["served"])
    for i in rng.permutation(len(done)):
        if n >= SAMPLE_TOKENS or len(picked) >= SAMPLE_MAX:
            break
        if i != longest:
            picked.append(done[i])
            n += len(done[i]["served"])
    return picked


def sequences(picked: Sequence[dict], device):
    seqs = [torch.as_tensor(np.concatenate([r["prompt"], r["served"]]), dtype=torch.long,
                            device=device) for r in picked]
    starts = [len(r["prompt"]) - 1 for r in picked]
    return seqs, starts


def gaps(ref_logits: Sequence[torch.Tensor], tokens: Sequence[torch.Tensor]) -> np.ndarray:
    """Per position, the reference's best logit less its logit of the
    token given there."""
    out = []
    for lg, tok in zip(ref_logits, tokens):
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, tok.view(-1, 1)).squeeze(1)).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def served_gaps(reference, model: dict, weights: Dict[str, torch.Tensor],
                picked: Sequence[dict], device):
    """(the configuration's reference's logits per sampled request, the
    served tokens' gaps)."""
    seqs, starts = sequences(picked, device)
    ref = reference.logits(model, weights, seqs, starts)
    served = [torch.as_tensor(r["served"], dtype=torch.long, device=device) for r in picked]
    return ref, gaps(ref, served)


def control_gaps(ref_logits, control_logits) -> np.ndarray:
    """Gaps of the tokens a lower precision puts first at each position."""
    return gaps(ref_logits, [lg.argmax(dim=-1) for lg in control_logits])


def checks(gap: np.ndarray, limit: float, unanswered: int, failed: int) -> Dict[str, dict]:
    """The numbers compared, each beside its limit."""
    widest = float(gap.max()) if gap.size else float("inf")
    return {"logit_gap": {"value": widest, "limit": float(limit)},
            "unanswered": {"value": int(unanswered), "limit": 0},
            "failed": {"value": int(failed), "limit": 0}}


def passed(c: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in c.values())
