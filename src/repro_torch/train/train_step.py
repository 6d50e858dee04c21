"""The train step: loss, gradients by autograd, AdamW, with microbatch
gradient accumulation and an optional int8 gradient quantisation.

The JAX package's ``train/train_step.py``: ``build_train_step`` returns the
``TracedStep`` the trainer runs, the counterpart of
``build_train_artifacts``' ``TracedJit``.  The step updates the state it
is handed in place (the JAX step donates it) and returns it with the
step's metrics, which stay on the device until read.

The state is stored as the JAX step's ``in_shardings`` /
``out_shardings`` store it on the ``Partitioner``'s mesh (without one, the
one-rank mesh, where every block is the whole leaf and no collective
runs, so the step is the one-device step): each rank holds its block of
every parameter and AdamW moment (``state_specs``; ``count`` whole), and
its rows of the batch (``batch_specs_sharded``).  JAX leaves the compute
layout to XLA, whose GSPMD splits each layer over "model"; the port
computes the same function the same way.  Each rank computes its rows; a
leaf split over "model" along its heads, KV heads, FFN columns or
vocabulary stays the rank's block where a block uses it (gathered over the
data axes only where ``fsdp`` splits its "embed" dimension there), so the
rank computes its heads and columns, sums after the output projections
and takes a vocabulary-parallel cross-entropy (``models.layers``); the MoE
experts stay on their "model" shard and tokens travel to them; every other
leaf is gathered whole.  The gradients of the blocks come from that local
compute (and through the gathers' transposes, summing reduce-scatters,
for what was gathered); :func:`reduce_grads` sums each over the axes its
leaf is replicated on and divides by the ranks (the mean over the data
axes: every "model" rank's loss counts, ``sharding.collectives``), and
AdamW updates the blocks in place.  The checkpoints hold the same blocks
as before: only the compute layout changed.  ``grad_compression``
quantises each row with the absmax of the whole row (a max all-reduce
where the last dimension is sharded), as JAX quantises the logical
array.

The parameters in the state need no gradient: each step differentiates
``detach()``-ed views of them (no copy), so the state never holds a graph.
On the card every op of the step is a plain PyTorch op: the JAX package
trains through ``layers.attend_cfg`` and no kernel, and the port's kernels
refuse to run under autograd (``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.interception import TracedStep, nbytes_of
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.param import DTYPES
from repro_torch.models.param import axes as spec_axes
from repro_torch.models.param import shapes as spec_shapes
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.compression import dequantize_int8, quantize_int8
from repro_torch.sharding import collectives as C
from repro_torch.sharding.partition import PartitionSpec, Partitioner
from repro_torch.sharding.placement import block_shape, local_block, place


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()
    #: int8 quantise–dequantise of every gradient before the optimizer (the
    #: wire format of the compressed data-parallel reduction)
    grad_compression: bool = False


def state_specs(model: Model, partitioner: Partitioner, tcfg: TrainConfig):
    """(state as meta tensors, state specs) for {params, opt}."""
    p_meta = model.shapes()
    p_specs = partitioner.tree_pspecs(p_meta, model.axes())
    sdt = DTYPES[tcfg.adamw.state_dtype]
    mom = tree.map(lambda t: torch.empty(t.shape, dtype=sdt, device="meta"), p_meta)
    shapes = {"params": p_meta, "opt": {"mu": mom, "nu": mom, "count": torch.empty((), dtype=torch.int32, device="meta")}}
    specs = {"params": p_specs, "opt": {"mu": p_specs, "nu": p_specs, "count": PartitionSpec()}}
    return shapes, specs


def batch_specs_sharded(model: Model, partitioner: Partitioner, shape: ShapeSpec):
    """(batch as meta tensors, batch specs): the rows over the data axes."""
    b = model.batch_specs(shape)
    shapes = spec_shapes(b, model.cfg.dtype)
    return shapes, partitioner.tree_pspecs(shapes, spec_axes(b))


def _spec_map(fn, t, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its matching spec tree."""
    if isinstance(t, dict):
        return {k: _spec_map(fn, t[k], specs[k]) for k in t}
    if isinstance(t, list):
        return [_spec_map(fn, v, specs[i]) for i, v in enumerate(t)]
    return fn(t, specs)


def one_rank(partitioner: Optional[Partitioner]) -> Partitioner:
    """``partitioner``, or the one-rank mesh's when it is None."""
    return Partitioner(Mesh({"data": 1, "model": 1})) if partitioner is None else partitioner


def init_state(model: Model, tcfg: TrainConfig, generator: torch.Generator, partitioner: Optional[Partitioner] = None) -> dict:
    """{params, opt} on ``generator.device``, the weights drawn from it;
    each leaf is this rank's block (every rank draws the same weights from
    the same seed and keeps its block; a leaf that is not split is kept as
    drawn)."""
    partitioner = one_rank(partitioner)
    _, specs = state_specs(model, partitioner, tcfg)
    params = _spec_map(lambda t, s: local_block(t, s, partitioner.mesh).clone() if s.mesh_axes() else t,
                       model.init(generator), specs["params"])
    return {"params": params, "opt": adamw_init(params, tcfg.adamw)}


def _maybe_compress(grads, on: bool, mesh, specs):
    if not on:
        return grads

    def qdq(g, spec):
        if g.ndim == 0:
            return g
        rows = spec.mesh_axes() if g.ndim == 1 else spec.axes_of(g.ndim - 1)
        q, s = quantize_int8(g, mesh, rows)
        return dequantize_int8(q, s).reshape(g.shape).to(g.dtype)

    return _spec_map(qdq, grads, specs)


def reduce_grads(grads: dict, specs: dict, mesh) -> dict:
    """Each rank's gradients of its blocks (each the gradient of the sum of
    the ranks' losses with respect to the block: ``sharding.collectives``)
    summed over the axes the leaf is replicated on and divided by the
    ranks: the gradient of the mean of the ranks' losses, which is the mean
    over the data axes."""
    n = mesh.size
    if n == 1:
        return grads

    def red(g, spec):
        rest = tuple(a for a in mesh.axis_names if a not in spec.mesh_axes())
        return C.psum(g, mesh, rest) / n

    return _spec_map(red, grads, specs)


def loss_and_grads(model: Model, params: dict, batch: dict, microbatches: int = 1, view=None) -> Tuple[torch.Tensor, dict, dict]:
    """(loss, gradients in ``params``' structure, the loss's scalar metrics).
    With ``microbatches`` k > 1 the batch is split into k along its first
    axis and the gradients summed in fp32 and divided by k, as the JAX
    step's scan does; its metrics are then empty.  ``view`` turns the
    differentiated leaves into what the model takes (on a mesh, the
    ``Placed`` blocks)."""

    def grads_of(mb):
        p = tree.map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = model.loss(p if view is None else view(p), mb)
        grads = torch.autograd.grad(loss, tree.leaves(p))
        return loss.detach(), tree.unflatten(params, list(grads)), metrics

    k = microbatches
    if k == 1:
        loss, grads, metrics = grads_of(batch)
        return loss, grads, {m: v.detach().float() for m, v in metrics.items() if v.ndim == 0}
    micro = {n: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:])) for n, x in batch.items()}
    g_acc = tree.map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), params)
    l_acc = 0.0
    for i in range(k):
        loss, grads, _ = grads_of({n: x[i] for n, x in micro.items()})
        g_acc = tree.map(lambda a, b: a + b.float(), g_acc, grads)
        l_acc = l_acc + loss
    return l_acc / k, tree.map(lambda g: g / k, g_acc), {}


def build_train_step(model: Model, shape: ShapeSpec, tcfg: TrainConfig, device,
                     partitioner: Optional[Partitioner] = None) -> TracedStep:
    """``step(state, batch) -> (state, metrics)`` under THAPI interception,
    named ``train_step[<config>/<shape>]``, with the model's FLOPs for the
    step's tokens (forward and backward, 3×) and this rank's state bytes.
    The state is ``init_state``'s blocks for the same ``partitioner`` (None:
    the one-rank mesh) and the batch the whole batch, of which the step
    takes this rank's rows."""
    k = tcfg.microbatches
    if shape.global_batch % k:
        raise ValueError(f"global_batch {shape.global_batch} % microbatches {k} != 0")
    partitioner = one_rank(partitioner)
    mesh = partitioner.mesh
    model = model.on_mesh(mesh)
    meta, specs = state_specs(model, partitioner, tcfg)
    state_bytes = nbytes_of(_spec_map(  # the rank's blocks
        lambda t, s: torch.empty(block_shape(t.shape, s, mesh), dtype=t.dtype, device="meta"), meta, specs))
    _, b_specs = batch_specs_sharded(model, partitioner, shape)
    view = functools.partial(place, specs=specs["params"], mesh=mesh, keep_local=model.keep_local,
                             axes=model.axes())

    def step_fn(state: dict, batch: dict):
        params, opt = state["params"], state["opt"]
        lr = warmup_cosine(opt["count"], peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        batch = {n: local_block(x, b_specs[n], mesh) for n, x in batch.items()}
        loss, grads, metrics = loss_and_grads(model, params, batch, k, view)
        grads = _maybe_compress(reduce_grads(grads, specs["params"], mesh), tcfg.grad_compression,
                                mesh, specs["params"])
        loss = C.pmean(loss, mesh, mesh.axis_names)
        metrics = {m: C.pmean(v, mesh, mesh.axis_names) for m, v in metrics.items()}
        _, _, gnorm = adamw_update(grads, opt, params, lr, tcfg.adamw, mesh, specs["params"])
        out: Dict[str, torch.Tensor] = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr, **metrics}
        return state, out

    return TracedStep(
        step_fn,
        name=f"train_step[{model.cfg.name}/{shape.name}]",
        device=device,
        flops=model.model_flops_per_token() * shape.tokens * 3,  # forward + backward ≈ 3×
        bytes_accessed=state_bytes,
        donate_argnums=(0,),
    )
