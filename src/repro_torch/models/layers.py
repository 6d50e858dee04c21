"""Shared building blocks of the SSM serving path: RMSNorm and embeddings.

Pure functions on tensors (params in, tensors out), mirroring the JAX
package's ``models/layers.py`` for the pieces the Mamba2 family uses.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig
from .param import Spec


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with a zero-centred gain: scales by ``1 + w``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def norm_spec(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is ported in a later slice, see ROADMAP.md")
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    return {"w": Spec(lead + (cfg.d_model,), lax + ("embed",), "zeros")}


def embed_specs(cfg: ModelConfig) -> dict:
    V, d = cfg.padded_vocab, cfg.d_model
    s = {"tok": Spec((V, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tied_embeddings:
        s["head"] = Spec((d, V), ("embed", "vocab"))
    return s


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tied_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]
