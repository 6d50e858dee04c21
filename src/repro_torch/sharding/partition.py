"""Logical-axis partitioning: logical names → mesh partition specs.

Every parameter and activation of the model zoo is annotated with logical
axes (``("layers", "embed", "heads", "head_dim")`` …).  This module maps
them onto the mesh axes ``("pod", "data", "model")`` as the JAX package's
``sharding/partition.py`` does, rule for rule, with its divisibility
fallback: a dimension that does not divide over its rule's mesh axes takes
the longest prefix that divides, and at last replication.

Sharding modes:
  tp      — Megatron-style: weights sharded over "model" (heads / ffn /
            vocab / experts / channels); batch over ("pod", "data").
  fsdp    — ZeRO-3-ish: also shards the "embed" dimension of weights over
            ("pod", "data").
  serve2d — resident MoE serving: experts over "model" × the expert FFN
            dimension over the data axes; the KV cache's sequence over
            "model".

A spec is the port's :class:`PartitionSpec`, a tuple with one entry per
leading dimension (``None``, an axis name, or a tuple of axis names),
trailing ``None`` trimmed as JAX trims them.  On a mesh backed by a process
group :meth:`Partitioner.placements` also gives a leaf's DTensor
placements.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# logical axis → mesh axes (tried in order; longest dividing prefix wins)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    # data-parallel axes
    "batch": ("pod", "data"),
    # tensor-parallel axes
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "channels": ("model",),  # RG-LRU / SSM channel dims
    "ssm_heads": ("model",),
    # sequence parallelism (activations only; enabled for long shapes)
    "seq_sp": ("model",),
    # replicated by default
    "embed": (),
    "layers": (),
    "seq": (),
    "head_dim": (),
    "state": (),
    "expert_mlp": (),
    "conv": (),
}

FSDP_OVERRIDES: Dict[str, Tuple[str, ...]] = {
    # ZeRO-3: weight "embed" dims sharded over the data axes too
    "embed": ("pod", "data"),
    "layers": (),
}

SERVE2D_OVERRIDES: Dict[str, Tuple[str, ...]] = {
    # trillion-param MoE serving: experts over "model" (rule above) × the
    # expert FFN dim over the data axes, so decode moves activations
    # instead of gathering weights; the KV cache's sequence over "model"
    "expert_mlp": ("pod", "data"),
    "seq": ("model",),
}

DATA_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per leading dimension: ``None`` (replicated), an axis name,
    or a tuple of axis names (major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that shard dimension ``dim``, major to minor."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    def mesh_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec shards over, in entry order."""
        return tuple(a for d in range(len(self)) for a in self.axes_of(d))


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def _fit_axes(dim: int, axes: Sequence[str], mesh) -> Tuple[str, ...]:
    """Longest prefix of ``axes`` (present in mesh) whose product divides dim."""
    present = [a for a in axes if a in mesh.shape]
    best: Tuple[str, ...] = ()
    prod = 1
    for a in present:
        prod *= _axis_size(mesh, a)
        if prod == 1:
            continue
        if dim % prod == 0:
            best = tuple(present[: present.index(a) + 1])
        else:
            break
    return best


def _prod(mesh, axes: Sequence[str]) -> int:
    out = 1
    for a in axes:
        out *= _axis_size(mesh, a)
    return out


def logical_to_pspec(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> PartitionSpec:
    """Map logical axes of one array to a partition spec for ``mesh`` (any
    object with a ``shape`` dict of axis sizes)."""
    rules = rules or LOGICAL_RULES
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {shape} rank mismatch")
    used: set = set()
    entries = []
    for ax, dim in zip(axes, shape):
        if ax is None:
            entries.append(None)
            continue
        rule = rules.get(ax)
        if rule is None:
            raise KeyError(f"no partition rule for logical axis {ax!r}")
        fit = tuple(a for a in _fit_axes(dim, rule, mesh) if a not in used)
        # re-check divisibility after removing already-used axes
        while fit and dim % _prod(mesh, fit) != 0:
            fit = fit[:-1]
        if not fit:
            entries.append(None)
            continue
        used.update(fit)
        entries.append(fit if len(fit) > 1 else fit[0])
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def spec_items(specs, prefix: str = ""):
    """(key, spec) pairs of a tree of specs in leaf order (a spec is a
    tuple, so ``repro_torch.tree`` would walk into it)."""
    if isinstance(specs, PartitionSpec):
        yield prefix[:-1], specs
    elif isinstance(specs, dict):
        for k in sorted(specs):
            yield from spec_items(specs[k], f"{prefix}{k}/")
    else:
        for i, v in enumerate(specs):
            yield from spec_items(v, f"{prefix}{i}/")


@dataclasses.dataclass
class Partitioner:
    """Bound (mesh, mode) partitioning helper.

    mode: "tp" (Megatron TP), "fsdp" (ZeRO-3 weights over the data axes),
    "serve2d" (resident 2-D expert sharding for MoE decode).
    ``fsdp=True`` is sugar for mode="fsdp".
    """

    mesh: object
    fsdp: bool = False
    mode: str = ""

    def __post_init__(self):
        if not self.mode:
            self.mode = "fsdp" if self.fsdp else "tp"
        self.fsdp = self.mode == "fsdp"

    @property
    def rules(self) -> Dict[str, Tuple[str, ...]]:
        r = dict(LOGICAL_RULES)
        if self.mode == "fsdp":
            r.update(FSDP_OVERRIDES)
        elif self.mode == "serve2d":
            r.update(SERVE2D_OVERRIDES)
        return r

    def pspec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> PartitionSpec:
        return logical_to_pspec(axes, shape, self.mesh, self.rules)

    def tree_pspecs(self, shapes_tree, axes_tree):
        """Matching trees of shapes (tensors, meta tensors or shape tuples)
        and logical-axes tuples → a tree of specs."""

        def walk(s, a):
            if _is_axes(a):
                return self.pspec(a, tuple(s.shape) if hasattr(s, "shape") else tuple(s))
            if isinstance(a, dict):
                return {k: walk(s[k], a[k]) for k in a}
            return [walk(si, ai) for si, ai in zip(s, a)]

        return walk(shapes_tree, axes_tree)

    def placements(self, spec: PartitionSpec) -> tuple:
        """DTensor placements of a leaf with ``spec`` on the mesh's
        ``DeviceMesh``: ``Shard(i)`` for each mesh axis that shards tensor
        dimension i, ``Replicate()`` for the others, in mesh-axis order."""
        from torch.distributed.tensor import Replicate, Shard

        self.mesh.device_mesh_or_raise()
        out = []
        for name in self.mesh.axis_names:
            dims = [d for d in range(len(spec)) if name in spec.axes_of(d)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.mesh.shape)

    def model_axis_size(self) -> int:
        return _axis_size(self.mesh, "model")

    def dp_size(self) -> int:
        return _prod(self.mesh, self.data_axes())

