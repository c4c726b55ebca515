"""What a traffic generator hands the driver."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (P,) int32
    new_tokens: int
    due: Optional[float]            # seconds from the window's opening; None: backlog
    warm: bool = False              # made for the warm-up, never judged


@dataclasses.dataclass
class Traffic:
    kind: str                       # "backlog" | "poisson"
    slots: int
    max_prompt_len: int
    max_new_tokens: int
    requests: Sequence[Request]     # backlog: made on demand, no end
    depth: int = 0                  # backlog: queue kept at least this deep
