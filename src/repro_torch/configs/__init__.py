"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port registers the dense families its slices run so far.
"""
from __future__ import annotations

from repro_torch.core.config import ModelConfig
from repro_torch.configs.quasar_paper import CONFIG as quasar_paper
from repro_torch.configs.smollm import CONFIG as smollm

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in [smollm, quasar_paper]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
