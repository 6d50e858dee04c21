"""The train step: loss, gradients by autograd, AdamW, with microbatch
gradient accumulation and an optional int8 gradient quantisation.

The JAX package's ``train/train_step.py`` on one device, without the
shardings: ``build_train_step`` returns the ``TracedStep`` the trainer
runs, the counterpart of ``build_train_artifacts``' ``TracedJit``.  The
step updates the state it is handed in place (the JAX step donates it) and
returns it with the step's metrics, which stay on the device until read.

The parameters in the state need no gradient: each step differentiates
``detach()``-ed views of them (no copy), so the state never holds a graph.
On the card every op of the step is a plain PyTorch op: the JAX package
trains through ``layers.attend_cfg`` and no kernel, and the port's kernels
refuse to run under autograd (``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.core.interception import TracedStep, nbytes_of
from repro_torch.models import Model, ShapeSpec
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.compression import dequantize_int8, quantize_int8


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


def init_state(model: Model, tcfg: TrainConfig, generator: torch.Generator) -> dict:
    """{params, opt} on ``generator.device``, the weights drawn from it."""
    params = model.init(generator)
    return {"params": params, "opt": adamw_init(params, tcfg.adamw)}


def _maybe_compress(grads, on: bool):
    if not on:
        return grads

    def qdq(g):
        if g.ndim == 0:
            return g
        q, s = quantize_int8(g)
        return dequantize_int8(q, s).reshape(g.shape).to(g.dtype)

    return tree.map(qdq, grads)


def loss_and_grads(model: Model, params: dict, batch: dict, microbatches: int = 1) -> Tuple[torch.Tensor, dict, dict]:
    """(loss, gradients in ``params``' structure, the loss's scalar metrics).
    With ``microbatches`` k > 1 the batch is split into k along its first
    axis and the gradients summed in fp32 and divided by k, as the JAX
    step's scan does; its metrics are then empty."""

    def grads_of(mb):
        p = tree.map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = model.loss(p, mb)
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


def build_train_step(model: Model, shape: ShapeSpec, tcfg: TrainConfig, device) -> TracedStep:
    """``step(state, batch) -> (state, metrics)`` under THAPI interception,
    named ``train_step[<config>/<shape>]``, with the model's FLOPs for the
    step's tokens (forward and backward, 3×) and the state's bytes."""
    k = tcfg.microbatches
    if shape.global_batch % k:
        raise ValueError(f"global_batch {shape.global_batch} % microbatches {k} != 0")
    meta = model.shapes()  # the state's sizes, without its storage
    state_bytes = nbytes_of({"params": meta, "opt": adamw_init(meta, tcfg.adamw)})

    def step_fn(state: dict, batch: dict):
        params, opt = state["params"], state["opt"]
        lr = warmup_cosine(opt["count"], peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        loss, grads, metrics = loss_and_grads(model, params, batch, k)
        grads = _maybe_compress(grads, tcfg.grad_compression)
        _, _, gnorm = adamw_update(grads, opt, params, lr, tcfg.adamw)
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
