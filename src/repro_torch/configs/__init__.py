"""Config registry: ``get_config(arch_id)`` for every arch of the
reference's registry (``repro.configs``), in its order; the dry-run's input
shapes (``get_shape``) and which (arch × shape) cells apply
(``cell_is_runnable``)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, MeshConfig,
                                      ModelConfig, ShapeConfig, TrainConfig,
                                      reduced)

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


def get_shape(shape_id: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == shape_id:
            return s
    raise KeyError(f"unknown shape {shape_id!r}")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) cell of the dry-run applies: a
    full-attention arch does not decode 500k tokens."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, ("full-attention arch: 500k-token decode is quadratic "
                       "in cache reads per token and exceeds the KV budget; "
                       "skipped per assignment (see DESIGN.md)")
    return True, ""


__all__ = ["ALL_SHAPES", "ARCH_IDS", "MeshConfig", "ModelConfig",
           "ShapeConfig", "TrainConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "get_config", "get_shape",
           "cell_is_runnable", "reduced"]
