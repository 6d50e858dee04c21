"""AdamW with decoupled weight decay, global-norm clipping and a
configurable optimizer-state dtype, on trees of tensors.

The JAX package's ``optim/adamw.py``: every update runs in fp32 and is
cast back to the parameter's and the state's dtypes.  The update writes
the new parameters and moments into the tensors it was given, the
counterpart of the JAX train step donating its state: it holds one leaf's
fp32 temporaries at a time beside the state.  On a mesh each rank updates
its blocks of the leaves, and the gradient norm sums every block of a
sharded leaf (``global_norm`` with the leaves' specs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import tree
from repro_torch.models.param import DTYPES
from repro_torch.sharding import collectives as C


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def global_norm(grads, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in leaf order) of each leaf's fp32 sum of
    squares.  With ``specs`` (a tree of the leaves' specs on ``mesh``) the
    leaves are this rank's blocks: the sums of leaves sharded over the
    same axes are all-reduced over those axes, so every block counts once."""
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.leaves(grads)))
    from repro_torch.sharding.partition import spec_items

    by_axes: dict = {}
    for g, (_, spec) in zip(tree.leaves(grads), spec_items(specs), strict=True):
        key = spec.mesh_axes()
        by_axes[key] = by_axes.get(key, 0.0) + torch.sum(torch.square(g.float()))
    return torch.sqrt(sum(C.psum(v, mesh, axes) for axes, v in by_axes.items()))


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = DTYPES[cfg.state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "mu": tree.map(zeros, params),
        "nu": tree.map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device),
    }


def adamw_update(grads, state: dict, params, lr, cfg: AdamWConfig, mesh=None, specs=None) -> Tuple[dict, dict, torch.Tensor]:
    """Writes the new values into ``params`` and ``state`` and returns
    (params, state, pre-clip global gradient norm); ``mesh`` and ``specs``
    as ``global_norm`` takes them."""
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + cfg.weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)

    tree.map(upd, grads, state["mu"], state["nu"], params)
    state["count"].copy_(count)
    return params, state, gnorm
