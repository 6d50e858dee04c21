"""Gradient compression formats of the data-parallel reduction.

  * ``quantize_int8`` — per-row absmax int8 (rows are the leading dims),
    with fp32 scales; ``dequantize_int8`` undoes it;
  * ``topk_sparsify`` — the k largest-magnitude entries as values and
    flat indices; ``topk_densify`` scatters them back.

The train step's ``grad_compression`` runs the int8 quantise–dequantise on
every gradient, as the JAX package's does.  ``compressed_mean`` is the
int8 mean over a mesh axis: each rank quantises its tensor, the int8
values and fp32 scales are all-gathered (about a byte an element on the
wire where ``pmean`` moves the dtype's width), and each rank dequantises
and takes the mean in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.sharding import collectives as C


def quantize_int8(x: torch.Tensor, mesh=None, row_axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [...] -> (int8 values of x's shape, fp32 scales [..., 1]); a 1-D x
    is one row with a scale of shape (1,).  When x is a block of a tensor
    whose rows are split over the mesh axes ``row_axes``, each row's absmax
    is the maximum over those ranks: the scale of the whole row."""
    xf = x.float()
    flat = xf.reshape(-1, xf.shape[-1]) if xf.ndim > 1 else xf.reshape(1, -1)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True)
    if row_axes:
        scale = C.pmax(scale, mesh, row_axes)
    scale = scale / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    if x.ndim > 1:
        return q.reshape(x.shape), scale.reshape(x.shape[:-1] + (1,))
    return q.reshape(-1), scale.reshape((1,))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest-magnitude entries of the flattened x: (values, indices)."""
    flat = x.float().reshape(-1)
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_densify(vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    return torch.zeros(size, dtype=torch.float32, device=vals.device).index_put((idx,), vals)


def compressed_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The int8-compressed mean of ``x`` over the ranks of ``axis``, in
    ``x``'s dtype (``lax.pmean`` with an int8 wire)."""
    q, scale = quantize_int8(x)
    qg = C.all_gather(q[None], mesh, axis)
    sg = C.all_gather(scale[None], mesh, axis)
    return torch.mean(qg.float() * sg, dim=0).to(x.dtype)
