"""Assigned-architecture registry: ``--arch <id>`` resolves here.

Each module defines ``config() -> ModelConfig`` with the exact published
numbers ([source; verified-tier] in the module docstring).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "recurrentgemma-2b",
    "qwen1.5-32b",
    "h2o-danube-1.8b",
    "mistral-large-123b",
    "stablelm-3b",
    "whisper-medium",
    "moonshot-v1-16b-a3b",
    "kimi-k2-1t-a32b",
    "mamba2-1.3b",
    "llava-next-34b",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")
    return mod.config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
