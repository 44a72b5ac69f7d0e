"""Architecture config registry of the port: ``get_config("yi-6b")``.

The port has every architecture of the reference: the dense, MoE and VLM
decoder-only models (serving and training), the Mamba2 SSM, the hybrid and
the encoder-decoder.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config"]
