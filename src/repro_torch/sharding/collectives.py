"""Collectives over a named mesh axis, differentiable, each under THAPI's
``collective_span``.

The counterparts of ``lax.axis_index``, ``psum``, ``pmean``,
``all_gather`` and ``all_to_all`` inside the JAX package's ``shard_map``.
Each runs over the process group of this rank's line along the axis
(:meth:`Mesh.group`); an axis of size 1 is the identity and runs nothing.
Under autograd each backward is the transposed collective, as ``jax.grad``
transposes a ``shard_map``: ``psum``'s is ``psum``, ``all_gather``'s a
summing reduce-scatter, ``all_to_all``'s the ``all_to_all`` back.  So when every rank runs backward from its own loss,
each rank's gradient of its inputs is that of the sum of the ranks'
losses.

That rule also carries the tensor-parallel layers: every rank of the
"model" axis computes the same loss on the same rows, and a ``psum`` after
a row-parallel product (``wo``, ``w_down``, the vocabulary-parallel
lookup and log-sum-exp) sends each rank the sum of the ranks' cotangents,
so a block's gradient comes out "model" times the one-rank gradient of
the rank's rows, and so does the sum over the "model" ranks of a
replicated leaf's gradients.  The train step's
``reduce_grads`` sums over the axes a leaf is replicated on and divides by
every rank, which undoes exactly that: no Megatron pair of operators
(identity forward, ``psum`` backward) is needed, and it would break the
rule that the expert-parallel paths and ``reduce_grads`` rely on.

A ``gloo`` group carries tensors through host memory: a CUDA tensor is
copied to the host, reduced or moved there and copied back.  There sums
of 16-bit floats run in fp32 and round once, and a reduce-scatter is an
all-reduce and a slice (``gloo`` has neither 16-bit sums nor a
reduce-scatter in every PyTorch release).  Other backends (NCCL) reduce
in the tensor's dtype and reduce-scatter natively.  Moves carry 16-bit
floats as their bytes.

The JAX package records these spans only outside ``jit``; the eager port
records one per call, as ``kernel_span`` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.interception import collective_span

Axes = Union[str, Sequence[str]]

_HALF = (torch.float16, torch.bfloat16)


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _n(mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return mesh.index(axis) if _n(mesh, axis) > 1 else 0


def _on_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _stage(t: torch.Tensor, group) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.cpu() if t.device.type != "cpu" and _on_host(group) else t


def _raw_sum(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    g = mesh.group(axis)
    h = _stage(x, g)
    h = h.float() if h.dtype in _HALF and _on_host(g) else h.clone()
    with collective_span("all_reduce", x.numel() * x.element_size(), axis, _n(mesh, axis)):
        dist.all_reduce(h, op=op, group=g)
    return h.to(device=x.device, dtype=x.dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit float as its bytes (gloo moves bytes of any release; not
    every release moves 16-bit words)."""
    return t.view(torch.uint8) if t.dtype in _HALF else t


def _raw_all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    g = mesh.group(axis)
    h = _bits(_stage(x, g))
    parts = [torch.empty_like(h) for _ in range(_n(mesh, axis))]
    with collective_span("all_gather", x.numel() * x.element_size(), axis, len(parts)):
        dist.all_gather(parts, h, group=g)
    return torch.cat(parts, dim=dim).view(x.dtype).to(x.device)


def _raw_reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over the axis, this rank's ``1/n`` slice along ``dim``."""
    n = _n(mesh, axis)
    g = mesh.group(axis)
    if not _on_host(g):
        h = x.detach().movedim(dim, 0).contiguous()
        out = h.new_empty((h.shape[0] // n,) + tuple(h.shape[1:]))
        with collective_span("reduce_scatter", x.numel() * x.element_size(), axis, n):
            dist.reduce_scatter_tensor(out, h, group=g)
        return out.movedim(0, dim).contiguous()
    h = _stage(x, g)
    h = h.float() if h.dtype in _HALF else h.clone()
    with collective_span("reduce_scatter", x.numel() * x.element_size(), axis, n):
        dist.all_reduce(h, group=g)
    i = mesh.index(axis)
    size = x.shape[dim] // n
    return h.narrow(dim, i * size, size).to(device=x.device, dtype=x.dtype).contiguous()


def _raw_all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk j of dimension 0 to rank j; the chunks received, in rank
    order, along dimension 0."""
    g = mesh.group(axis)
    h = _bits(_stage(x, g))
    out = torch.empty_like(h)
    with collective_span("all_to_all", x.numel() * x.element_size(), axis, _n(mesh, axis)):
        dist.all_to_all_single(out, h, group=g)
    return out.view(x.dtype).to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _raw_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _raw_sum(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _raw_all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_to_all(g, ctx.mesh, ctx.axis), None, None


def any_rank(mesh, *flags: bool) -> Tuple[bool, ...]:
    """Each flag, true where it is true on any rank of ``mesh`` (a max
    all-reduce of a few bytes over the process group the mesh spans; the
    flags as given on a one-rank mesh).  The ranks agree through it on what
    every rank must do alike."""
    if mesh.size == 1:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    if not _on_host(None):
        t = t.cuda()
    with collective_span("all_reduce", t.numel() * t.element_size(), "world", mesh.size):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(bool(v) for v in t.tolist())


def from_rank0(mesh, obj):
    """Rank 0's ``obj`` on every rank of ``mesh`` (``obj`` itself on a
    one-rank mesh)."""
    if mesh.size == 1:
        return obj
    box = [obj]
    with collective_span("broadcast", 0, "world", mesh.size):
        dist.broadcast_object_list(box, src=0)
    return box[0]


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum over every rank along ``axes`` (``lax.psum``)."""
    for a in _axes(axes):
        if _n(mesh, a) > 1:
            x = _Psum.apply(x, mesh, a)
    return x


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The mean over every rank along ``axes`` (``lax.pmean``)."""
    n = 1
    for a in _axes(axes):
        n *= _n(mesh, a)
    return psum(x, mesh, axes) / n if n > 1 else x


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (``lax.pmax``); no gradient."""
    for a in _axes(axes):
        if _n(mesh, a) > 1:
            x = _raw_sum(x, mesh, a, op=dist.ReduceOp.MAX)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, mesh, axis, dim) if _n(mesh, axis) > 1 else x


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: chunk j of
    dimension 0 goes to rank j, and the chunks received come back in rank
    order along dimension 0."""
    return _AllToAll.apply(x, mesh, axis) if _n(mesh, axis) > 1 else x
