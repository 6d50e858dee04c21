"""Where each rank's share of a sharded tensor lives, and how it becomes
the tensor a computation wants.

A rank holds of a leaf with spec ``P`` the block that ``P`` gives it: along
dimension i, ``1/k`` of the dimension where the entry's axes have k ranks
between them, the blocks in row-major order of the rank's indices on those
axes (the JAX ``NamedSharding`` layout).  :func:`local_block` cuts it from
the whole tensor, :func:`gather_whole` rebuilds the whole tensor from the
blocks (a differentiable ``all_gather`` per axis, minor axis first), and
:func:`reshard` turns one spec's block into another's.

A :class:`Placed` leaf is a rank's block with its spec, handed to the
model in place of the whole tensor.  ``whole_at_use`` leaves are gathered
whole where a block uses them (:func:`at_use`; a layer-stacked leaf one
layer at a time, :meth:`Placed.layer`); the others (the MoE family's expert
weights) reach the layer that reshards them to its own spec.
"""

from __future__ import annotations

import dataclasses
import torch

from . import collectives as C
from .partition import PartitionSpec


@dataclasses.dataclass
class Placed:
    """A rank's block of a leaf: ``local``, its ``spec`` on ``mesh``."""

    local: torch.Tensor
    spec: PartitionSpec
    mesh: object
    whole_at_use: bool = True
    stacked: bool = False  # the leading dimension is "layers"

    def layer(self, l: int) -> "Placed":
        """Layer ``l`` of a layer-stacked leaf (the "layers" axis is never
        sharded), still a block."""
        spec = PartitionSpec(*self.spec[1:])
        return Placed(self.local[l], spec, self.mesh, self.whole_at_use, False)

    def layers(self) -> list:
        """Every layer's block, through one ``unbind`` (``layers.layer_slices``)."""
        spec = PartitionSpec(*self.spec[1:])
        return [Placed(t, spec, self.mesh, self.whole_at_use, False) for t in self.local.unbind(0)]

    def whole(self) -> torch.Tensor:
        return gather_whole(self.local, self.spec, self.mesh)


def _index_on(axes, mesh) -> tuple:
    """(blocks over ``axes``, this rank's block index, row major)."""
    n, i = 1, 0
    for a in axes:
        size = mesh.shape.get(a, 1)
        i = i * size + C.axis_index(mesh, a)
        n *= size
    return n, i


def _cut(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    n, i = _index_on(axes, mesh)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def local_block(whole: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of ``whole`` under ``spec`` (a view; slicing is
    differentiable)."""
    out = whole
    for d in range(len(spec)):
        out = _cut(out, d, spec.axes_of(d), mesh)
    return out


def block_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` (sizes only: any
    kind of mesh)."""
    out = list(shape)
    for d in range(len(spec)):
        for a in spec.axes_of(d):
            out[d] //= mesh.shape.get(a, 1)
    return tuple(out)


def gather_whole(local: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor from the ranks' blocks."""
    return reshard(local, spec, PartitionSpec(), mesh)


def reshard(local: torch.Tensor, have: PartitionSpec, want: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block under ``want`` from its block under ``have``: each
    dimension whose axes differ is gathered whole, then cut to ``want``."""
    out = local
    for d in range(max(len(have), len(want))):
        h, w = have.axes_of(d), want.axes_of(d)
        if h == w:
            continue
        for a in reversed(h):  # minor axis first: the blocks concatenate in row-major order
            out = C.all_gather(out, mesh, a, dim=d)
        out = _cut(out, d, w, mesh)
    return out


def take(leaf, want: PartitionSpec, mesh) -> torch.Tensor:
    """A tensor or :class:`Placed` leaf as this rank's block under ``want``."""
    if isinstance(leaf, Placed):
        return reshard(leaf.local, leaf.spec, want, leaf.mesh)
    return local_block(leaf, want, mesh)


def at_use(tree, top: bool = False):
    """``tree`` with its ``whole_at_use`` :class:`Placed` leaves gathered
    whole; with ``top``, only the leaves that are not layer-stacked (the
    stacked ones are gathered a layer at a time through
    ``layers.layer_slice``).  Other leaves pass as they are."""
    if isinstance(tree, Placed):
        if tree.whole_at_use and not (top and tree.stacked):
            return tree.whole()
        return tree
    if isinstance(tree, dict):
        return {k: at_use(v, top) for k, v in tree.items()}
    if isinstance(tree, list):
        return [at_use(v, top) for v in tree]
    return tree


def place(tree, specs, mesh, keep_local=(), axes=None):
    """``tree`` of this rank's blocks as :class:`Placed` leaves under the
    matching tree of ``specs``; leaves whose key is in ``keep_local`` are
    not gathered at use, and ``axes`` (the logical axes tree) marks the
    layer-stacked leaves."""

    def walk(t, s, a, key):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], a[k] if a is not None else None, k) for k in t}
        if isinstance(t, list):
            return [walk(v, s[i], a[i] if a is not None else None, key) for i, v in enumerate(t)]
        stacked = bool(a) and a[0] == "layers"
        return Placed(t, s, mesh, whole_at_use=key not in keep_local, stacked=stacked)

    return walk(tree, specs, axes, "")
