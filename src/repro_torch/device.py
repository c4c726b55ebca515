"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` whose default is
``"cuda"``: the port runs on the card unless its caller asks for the CPU.
With no card and no explicit CPU request it raises — it never falls back.
``"meta"`` builds shapes and dtypes only, with nothing allocated (the
launch tooling's dry-run, ``launch/shapes.py``).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available to this process; the port runs on "
            "the card by default — pass device='cpu' (--device cpu) to run "
            "its plain CPU path instead")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev
