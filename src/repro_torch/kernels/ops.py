"""Dispatch wrappers the models call.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in ``ref`` and a meta tensor to the shape function beside
it (outputs of the kernel's shapes and dtypes, no data: the dry run); any
other device raises.  There is no switch and no fallback: on the card the
kernel runs or the call raises.  No kernel
has a backward pass (no Pallas kernel of the JAX package has one either,
and ``jax.grad`` cannot differentiate them), so a CUDA call that autograd
would have to differentiate raises rather than return an output that
silently stops the gradient; on the CPU the plain versions are
differentiated as usual.  Each
kernel-backed op emits a THAPI ``ust_kernel:launch`` span with the same
analytic FLOPs and bytes as the JAX package's ``ops`` (so the spans compare);
eager PyTorch records one span per call where JAX records one per trace.
The dry run's counter (``launch.dryrun.Counter``), while one counts in this
thread, takes each call as one unit of those same FLOPs and bytes.
"""

from __future__ import annotations

import contextvars
from typing import Optional

import torch

from repro_torch.core.interception import kernel_span

from . import flash_attention as _flash
from . import ref as _ref
from .rglru_scan import rglru_scan
from .ssd_scan import ssd_scan

#: the dry run's counter while one counts in this thread (``launch.dryrun.Counter``)
counting: contextvars.ContextVar = contextvars.ContextVar("repro_torch_counting", default=None)


def _no_grad_through(name: str, *inputs) -> None:
    """Raises when autograd records and an input requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward pass, as the JAX package's Pallas "
            "kernel has none; call it under torch.no_grad() or on inputs that need no gradient"
        )


def _call(name: str, grid, flops: int, nbytes: int, t: torch.Tensor, kernel, plain, shape):
    """``kernel()`` for a CUDA ``t``, ``plain()`` for a CPU one, ``shape()``
    for a meta one, inside the op's span and, where a counter counts, as
    one unit of ``flops`` and ``nbytes``."""
    run = {"cuda": kernel, "cpu": plain, "meta": shape}.get(t.device.type)
    if run is None:
        raise ValueError(f"no kernel, plain version or shape function for device {t.device}")
    with kernel_span(name, grid, flops, nbytes):
        counter = counting.get()
        return run() if counter is None else counter.kernel(name, flops, nbytes, run)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 4 * B * H * S * T * hd // (2 if causal else 1)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) * 2

    def kernel():
        _no_grad_through("flash_attention", q, k, v)
        return _flash.flash_attention(q, k, v, causal=causal, window=window)

    return _call("flash_attention", (B, H, S), flops, nbytes, q, kernel,
                 lambda: _ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                 lambda: _ref.flash_attention_shape(q))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rglru(x, r, i, lam, h0=None):
    B, S, C = x.shape
    flops = 6 * B * S * C
    nbytes = 3 * B * S * C * x.element_size()

    def kernel():
        _no_grad_through("rglru", x, r, i, lam, h0)
        return rglru_scan(x, r, i, lam, h0=h0)

    return _call("rglru_scan", (B, S, C), flops, nbytes, x, kernel,
                 lambda: _ref.rglru_ref(x, r, i, lam, h0=h0), lambda: _ref.rglru_shape(x))


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def ssd(x, dt, A_log, Bm, Cm, D, *, chunk: int = 64, state0=None):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    flops = B * S * H * (2 * P * N * 3 + 2 * 64 * P)  # states + intra approx
    nbytes = (x.numel() + Bm.numel() * 2) * x.element_size() * 2

    def kernel():
        _no_grad_through("ssd", x, dt, A_log, Bm, Cm, D, state0)
        return ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)

    return _call("ssd_scan", (B, H, S // chunk), flops, nbytes, x, kernel,
                 lambda: _ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0),
                 lambda: _ref.ssd_shape(x, Bm))


# The JAX package has no TPU kernel for these three: plain PyTorch ops.


def rglru_step(h, x_t, r_t, i_t, lam):
    return _ref.rglru_step_ref(h, x_t, r_t, i_t, lam)


def ssd_step(state, x_t, dt_t, A_log, B_t, C_t, D):
    return _ref.ssd_step_ref(state, x_t, dt_t, A_log, B_t, C_t, D)


def causal_conv1d(x, w, state=None):
    return _ref.causal_conv1d_ref(x, w, state=state)
