"""Config registry: ``get_config(arch_id)`` for the archs the port runs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, TrainConfig, reduced

_PORTED = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "nemotron-4-15b": "repro_torch.configs.nemotron4_15b",
    "qwen2.5-3b": "repro_torch.configs.qwen2p5_3b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"{arch_id}: not ported yet (ported: {sorted(_PORTED)})")
    return importlib.import_module(_PORTED[arch_id]).CONFIG


__all__ = ["ModelConfig", "TrainConfig", "get_config", "reduced"]
