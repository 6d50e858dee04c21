"""Model facade over the serving families: SSM, hybrid, dense, MoE, audio
(encoder–decoder) and VLM (the dense model with a patch-embedding prefix).

    m = Model(cfg)
    m.param_specs()            spec tree (shapes/init in one declaration)
    m.init(generator)          tensors on the generator's device
    m.prefill / m.decode_step  serving steps
    m.cache_specs(shape)       serving-state Spec tree for decode shapes
"""

from __future__ import annotations

import torch

from . import encdec, hybrid, moe, ssm, transformer
from .config import ModelConfig, ShapeSpec
from .param import init as spec_init

_FAMILY = {
    "ssm": ssm,
    "hybrid": hybrid,
    "dense": transformer,
    "moe": moe,
    "audio": encdec,
    "vlm": transformer,
}


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mod = _FAMILY[cfg.family]

    # -- parameters ------------------------------------------------------------
    def param_specs(self) -> dict:
        return self.mod.specs(self.cfg)

    def init(self, generator: torch.Generator) -> dict:
        """Weights on ``generator.device``, drawn from ``generator``."""
        return spec_init(self.param_specs(), generator, self.cfg.dtype)

    # -- serving -----------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, cache_len: int):
        return self.mod.prefill(self.cfg, params, batch, cache_len)

    def decode_step(self, params: dict, cache: dict, batch: dict):
        return self.mod.decode_step(self.cfg, params, cache, batch)

    def cache_specs(self, shape: ShapeSpec) -> dict:
        return self.mod.cache_specs(self.cfg, shape.global_batch, shape.seq_len)
