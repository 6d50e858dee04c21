"""Parameter spec trees: one declaration drives init, shapes and sharding.

A model declares its parameters as a tree of dicts and lists with
:class:`Spec` leaves;
:func:`init` materializes it on a device from an explicit
``torch.Generator``, with the distributions of the JAX package's
``models/param.py`` (the random streams differ: tests that compare the two
packages carry JAX weights across with ``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | lru_a | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: Optional[str] = None  # override model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")


def _draw(s: Spec, shape: Tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """An fp32 draw of ``shape`` from the leaf's distribution."""
    if s.init == "lru_a":
        # RG-LRU Λ init: a in [0.9, 0.999] → Λ = softplus^-1(-log(a)/c), c = 8
        u = torch.empty(shape, device=gen.device).uniform_(0.9, 0.999, generator=gen)
        return torch.log(torch.expm1(-torch.log(u) / 8.0))
    if s.init == "ssm_a":
        # Mamba2 A init: -uniform[1, 16], stored as log
        return torch.log(torch.empty(shape, device=gen.device).uniform_(1.0, 16.0, generator=gen))
    if s.init == "ssm_dt":
        # dt bias ~ softplus^-1(uniform[1e-3, 1e-1])
        u = torch.empty(shape, device=gen.device).uniform_(1e-3, 1e-1, generator=gen)
        return torch.log(torch.expm1(u))
    if s.init != "normal":
        raise ValueError(f"unknown init {s.init!r}")
    return torch.randn(shape, device=gen.device, generator=gen).mul_(s.scale)


def _init_leaf(s: Spec, gen: torch.Generator, dtype: str) -> torch.Tensor:
    """The leaf in its dtype, filled one layer at a time when it is stacked
    over layers: a full-width expert leaf (moonshot-v1-16b-a3b's ``w_gate``,
    8.9e9 elements) would not fit the card as one fp32 draw, so init holds
    the weights and one layer's fp32 draw at most."""
    dt = DTYPES[s.dtype or dtype]
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=gen.device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=gen.device)
    out = torch.empty(s.shape, dtype=dt, device=gen.device)
    if s.axes[:1] == ("layers",):
        for layer in out:
            layer.copy_(_draw(s, s.shape[1:], gen))
    else:
        out.copy_(_draw(s, s.shape, gen))
    return out


def init(tree, gen: torch.Generator, dtype: str):
    """Materialize a spec tree on ``gen.device``; leaves draw in sorted-key
    order within a dict and in index order within a list, so one seed gives
    one set of weights."""
    if isinstance(tree, Spec):
        return _init_leaf(tree, gen, dtype)
    if isinstance(tree, list):
        return [init(v, gen, dtype) for v in tree]
    return {k: init(tree[k], gen, dtype) for k in sorted(tree)}


def zeros(tree, dtype: str, device):
    """A tree of zeros with each leaf's shape and dtype (serving caches)."""
    if isinstance(tree, Spec):
        return torch.zeros(tree.shape, dtype=DTYPES[tree.dtype or dtype], device=device)
    if isinstance(tree, list):
        return [zeros(v, dtype, device) for v in tree]
    return {k: zeros(v, dtype, device) for k, v in tree.items()}


def axes(tree):
    """The tree's logical-axes tuples (what ``sharding.Partitioner`` maps
    to specs)."""
    if isinstance(tree, Spec):
        return tree.axes
    if isinstance(tree, list):
        return [axes(v) for v in tree]
    return {k: axes(v) for k, v in tree.items()}


def shapes(tree, dtype: str):
    """The tree as meta tensors: each leaf's shape and dtype, no storage
    (the JAX ``ShapeDtypeStruct`` tree)."""
    if isinstance(tree, Spec):
        return torch.empty(tree.shape, dtype=DTYPES[tree.dtype or dtype], device="meta")
    if isinstance(tree, list):
        return [shapes(v, dtype) for v in tree]
    return {k: shapes(v, dtype) for k, v in tree.items()}

