"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port registers the dense and MoE families its slices run so far.
"""
from __future__ import annotations

from repro_torch.core.config import ModelConfig
from repro_torch.configs.arctic import CONFIG as arctic
from repro_torch.configs.moonshot import CONFIG as moonshot
from repro_torch.configs.phi35_moe import CONFIG as phi35_moe
from repro_torch.configs.quasar_paper import CONFIG as quasar_paper
from repro_torch.configs.smollm import CONFIG as smollm

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [phi35_moe, arctic, smollm, moonshot, quasar_paper]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
