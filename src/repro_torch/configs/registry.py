"""Architecture registry: ``--arch <id>`` → ModelConfig.

Counterpart of ``repro/configs/registry.py``; the config modules beside
it are copies of the JAX package's, field for field."""

from __future__ import annotations

import importlib

from .base import ModelConfig

# arch id → module name (ids keep the published naming)
ARCH_IDS: dict[str, str] = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "nemotron-4-340b": "nemotron4_340b",
    "smollm-360m": "smollm_360m",
    "command-r-35b": "command_r_35b",
    "starcoder2-15b": "starcoder2_15b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-tiny": "whisper_tiny",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_IDS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)
