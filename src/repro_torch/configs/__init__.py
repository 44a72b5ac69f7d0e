"""Architecture config registry of the port: ``get_config("yi-6b")``.

The port has the dense, MoE and VLM decoder-only models (serving and
training). The other architectures of the reference wait for the ROADMAP
items that port their model code.
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
}

# architectures of the reference that the port does not have yet, with the
# ROADMAP item that brings each
_LATER = {
    "zamba2-1.2b": "ROADMAP Queue 1 item 10 (LM stack: hybrid SSM)",
    "mamba2-130m": "ROADMAP Queue 1 item 10 (LM stack: SSM)",
    "whisper-tiny": "ROADMAP Queue 1 item 10 (LM stack: encoder-decoder)",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _LATER:
        raise NotImplementedError(f"{name} is not ported yet: {_LATER[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config"]
