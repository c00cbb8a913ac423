"""Config registry: ``get_config(arch_id)`` for every arch of the
reference's registry (``repro.configs``), in its order."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, TrainConfig, reduced

_REGISTRY: Dict[str, str] = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "qwen2.5-3b": "repro_torch.configs.qwen2p5_3b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "nemotron-4-15b": "repro_torch.configs.nemotron4_15b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch_id]).CONFIG


__all__ = ["ARCH_IDS", "ModelConfig", "TrainConfig", "get_config", "reduced"]
