"""Where each rank's share of a sharded tensor lives, and how it becomes
the tensor a computation wants.

A rank holds of a leaf with spec ``P`` the block that ``P`` gives it: along
dimension i, ``1/k`` of the dimension where the entry's axes have k ranks
between them, the blocks in row-major order of the rank's indices on those
axes (the JAX ``NamedSharding`` layout).  :func:`local_block` cuts it from
the whole tensor, :func:`gather_whole` rebuilds the whole tensor from the
blocks (a differentiable ``all_gather`` per axis, minor axis first), and
:func:`reshard` turns one spec's block into another's.

A checkpoint holds whole leaves: :func:`gather_to_host` brings a leaf whole
into rank 0's host memory from every rank's block, and a restore cuts each
rank's block from the whole leaf read from disk with :func:`local_block`
under the spec of the mesh it restores onto.

A :class:`Placed` leaf is a rank's block with its spec, handed to the
model in place of the whole tensor.  Where a block uses it (:func:`at_use`;
a layer-stacked leaf one layer at a time, :meth:`Placed.layer`) it becomes
the block of its ``kept`` spec: the entries of its spec on the dimensions
the model computes locally, which for the families that split a layer over
"model" are its heads, KV heads, FFN columns and vocabulary
(:data:`TENSOR_PARALLEL`), gathered over every other axis.  So such a layer
computes its own heads, columns and rows (:func:`block_range` says which)
and sums after its output projection, as GSPMD partitions the JAX step; a
dimension that does not divide the axis was never split (the partitioner's
replication fallback) and is whole on every rank.  A leaf split along
:data:`BLOCK_AXES` (the MoE family's expert weights) reaches its layer as
the ``Placed`` block, and the layer reshards it to its own spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from . import collectives as C
from .partition import PartitionSpec

#: the logical axes a tensor-parallel layer computes on this rank's block
TENSOR_PARALLEL = ("heads", "kv_heads", "mlp", "vocab")
#: the logical axes whose leaves reach their layer as :class:`Placed` blocks
BLOCK_AXES = ("experts",)


@dataclasses.dataclass
class Placed:
    """A rank's block of a leaf: ``local``, its ``spec`` on ``mesh``; at use
    the block of ``kept`` (whole by default), or, without ``whole_at_use``,
    the ``Placed`` block itself."""

    local: torch.Tensor
    spec: PartitionSpec
    mesh: object
    whole_at_use: bool = True
    stacked: bool = False  # the leading dimension is "layers"
    kept: PartitionSpec = PartitionSpec()

    def layer(self, l: int) -> "Placed":
        """Layer ``l`` of a layer-stacked leaf (the "layers" axis is never
        sharded), still a block."""
        return Placed(self.local[l], _tail(self.spec), self.mesh, self.whole_at_use, False, _tail(self.kept))

    def layers(self) -> list:
        """Every layer's block, through one ``unbind`` (``layers.layer_slices``)."""
        spec, kept = _tail(self.spec), _tail(self.kept)
        return [Placed(t, spec, self.mesh, self.whole_at_use, False, kept) for t in self.local.unbind(0)]

    def at_use(self) -> torch.Tensor:
        """The block of ``kept``: gathered over every axis ``kept`` drops."""
        return reshard(self.local, self.spec, self.kept, self.mesh)


def _tail(spec: PartitionSpec) -> PartitionSpec:
    return PartitionSpec(*spec[1:])


def kept_spec(spec: PartitionSpec, axes, local_axes) -> PartitionSpec:
    """``spec`` with only the entries of the dimensions whose logical axis is
    in ``local_axes`` (trailing ``None`` trimmed)."""
    entries = [spec[d] if d < len(spec) and axes[d] in local_axes else None for d in range(len(axes))]
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def block_range(whole: int, local: int, mesh, axis: str = "model") -> tuple:
    """(first, count) of the global indices a rank's block of ``local`` of a
    dimension of ``whole`` holds along ``axis``: the whole dimension when it
    was not split (``local == whole``), else block ``axis_index`` of
    ``whole // local``; a block without a ``mesh`` to place it raises."""
    if local == whole:
        return 0, whole
    if mesh is None:
        raise ValueError(f"a block of {local} of {whole} along {axis!r} with no mesh to place it")
    if whole % local or whole // local != mesh.shape.get(axis, 1):
        raise ValueError(f"a block of {local} of {whole} is not one of {mesh.shape.get(axis, 1)} along {axis!r}")
    return C.axis_index(mesh, axis) * local, local


def _index_on(axes, mesh, coords=None) -> tuple:
    """(blocks over ``axes``, the block index of this rank, or of the rank at
    ``coords``, row major)."""
    n, i = 1, 0
    for a in axes:
        size = mesh.shape.get(a, 1)
        i = i * size + (C.axis_index(mesh, a) if coords is None else coords.get(a, 0))
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


def gather_to_host(local: torch.Tensor, spec: PartitionSpec, mesh) -> Optional[torch.Tensor]:
    """The whole leaf in host memory on rank 0, from the ranks' blocks under
    ``spec``; None on the other ranks.  Each distinct block comes from one
    rank, the first that holds it (index 0 on every axis the spec does not
    split), sent to rank 0 as bytes and placed as it arrives; no rank's
    device holds more than its block.  A leaf that no axis of more than one
    rank splits is whole on every rank: rank 0 copies its own and nothing
    moves.  The mesh spans the whole group (:func:`make_local_mesh`).  Like
    the JAX checkpointer's host copy, the moves are no ``ust_collective``
    rows: the trace model has no point-to-point send."""
    rank = dist.get_rank() if mesh.size > 1 else 0
    split = [a for a in spec.mesh_axes() if mesh.shape.get(a, 1) > 1]
    if not split:
        return local.detach().to("cpu", copy=True) if rank == 0 else None
    owners = [r for r in range(mesh.size) if all(i == 0 for a, i in mesh.coords(r).items() if a not in split)]
    if rank != 0:
        if rank in owners:
            dist.send(C._stage(local, None).reshape(-1).view(torch.uint8), dst=0)
        return None
    shape = [local.shape[d] * _index_on(spec.axes_of(d), mesh, {})[0] for d in range(local.ndim)]
    whole = torch.empty(shape, dtype=local.dtype)
    for r in owners:
        if r == 0:
            block = local.detach().cpu()
        else:
            buf = torch.empty(local.numel() * local.element_size(), dtype=torch.uint8,
                              device="cpu" if C._on_host(None) else local.device)
            dist.recv(buf, src=r)
            block = buf.view(local.dtype).reshape(local.shape).cpu()
        at, coords = whole, mesh.coords(r)
        for d in range(local.ndim):
            _, i = _index_on(spec.axes_of(d), mesh, coords)
            at = at.narrow(d, i * local.shape[d], local.shape[d])
        at.copy_(block)
    return whole


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
    """``tree`` with its ``whole_at_use`` :class:`Placed` leaves turned into
    the blocks of their ``kept`` specs; with ``top``, only the leaves that are
    not layer-stacked (the stacked ones a layer at a time through
    ``layers.layer_slice``).  Other leaves pass as they are."""
    if isinstance(tree, Placed):
        if tree.whole_at_use and not (top and tree.stacked):
            return tree.at_use()
        return tree
    if isinstance(tree, dict):
        return {k: at_use(v, top) for k, v in tree.items()}
    if isinstance(tree, list):
        return [at_use(v, top) for v in tree]
    return tree


def place(tree, specs, mesh, keep_local=(), axes=None):
    """``tree`` of this rank's blocks as :class:`Placed` leaves under the
    matching tree of ``specs`` and of ``axes`` (the logical axes): a leaf
    keeps at use its split along the logical axes in ``keep_local``
    (``Model.keep_local``), and one split along a :data:`BLOCK_AXES` axis in
    ``keep_local`` reaches its layer as the block.  Without ``axes`` every
    leaf is gathered whole at use."""

    def walk(t, s, a):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], a[k] if a is not None else None) for k in t}
        if isinstance(t, list):
            return [walk(v, s[i], a[i] if a is not None else None) for i, v in enumerate(t)]
        a = a or ()
        block = any(x in keep_local for x in a if x in BLOCK_AXES)
        kept = kept_spec(s, a, keep_local) if a else PartitionSpec()
        return Placed(t, s, mesh, whole_at_use=not block, stacked=bool(a) and a[0] == "layers", kept=kept)

    return walk(tree, specs, axes)
