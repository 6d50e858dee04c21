"""Parameter spec trees: one declaration drives init and shapes.

A model declares its parameters as a nested dict of :class:`Spec` leaves;
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
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: Optional[str] = None  # override model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")


def _uniform(s: Spec, gen: torch.Generator, lo: float, hi: float) -> torch.Tensor:
    u = torch.empty(s.shape, dtype=torch.float32, device=gen.device)
    return u.uniform_(lo, hi, generator=gen)


def _init_leaf(s: Spec, gen: torch.Generator, dtype: str) -> torch.Tensor:
    dt = DTYPES[s.dtype or dtype]
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=gen.device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=gen.device)
    if s.init == "ssm_a":
        # Mamba2 A init: -uniform[1, 16], stored as log
        return torch.log(_uniform(s, gen, 1.0, 16.0)).to(dt)
    if s.init == "ssm_dt":
        # dt bias ~ softplus^-1(uniform[1e-3, 1e-1])
        return torch.log(torch.expm1(_uniform(s, gen, 1e-3, 1e-1))).to(dt)
    if s.init != "normal":
        raise ValueError(f"unknown init {s.init!r}")
    w = torch.randn(s.shape, dtype=torch.float32, device=gen.device, generator=gen)
    return (w * s.scale).to(dt)


def init(tree, gen: torch.Generator, dtype: str):
    """Materialize a spec tree on ``gen.device``; leaves draw in sorted-key
    order, so one seed gives one set of weights."""
    if isinstance(tree, Spec):
        return _init_leaf(tree, gen, dtype)
    return {k: init(tree[k], gen, dtype) for k in sorted(tree)}


def zeros(tree, dtype: str, device) -> dict:
    """A tree of zeros with each leaf's shape and dtype (serving caches)."""
    if isinstance(tree, Spec):
        return torch.zeros(tree.shape, dtype=DTYPES[tree.dtype or dtype], device=device)
    return {k: zeros(v, dtype, device) for k, v in tree.items()}
