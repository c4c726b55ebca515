"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

All eleven of the reference's configurations: the dense, MoE, SSM,
hybrid, vision-language (cross-attention) and audio (encoder-decoder)
families.
"""
from __future__ import annotations

from repro_torch.core.config import ModelConfig
from repro_torch.configs.arctic import CONFIG as arctic
from repro_torch.configs.codeqwen import CONFIG as codeqwen
from repro_torch.configs.llama32_vision import CONFIG as llama32_vision
from repro_torch.configs.mamba2 import CONFIG as mamba2
from repro_torch.configs.moonshot import CONFIG as moonshot
from repro_torch.configs.phi35_moe import CONFIG as phi35_moe
from repro_torch.configs.quasar_paper import CONFIG as quasar_paper
from repro_torch.configs.smollm import CONFIG as smollm
from repro_torch.configs.stablelm import CONFIG as stablelm
from repro_torch.configs.whisper import CONFIG as whisper
from repro_torch.configs.zamba2 import CONFIG as zamba2

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [phi35_moe, arctic, stablelm, smollm, codeqwen, moonshot,
                        quasar_paper, llama32_vision, whisper, mamba2, zamba2]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
