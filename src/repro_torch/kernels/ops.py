"""Dispatch wrappers the models call.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
PyTorch version in ``ref``; any other device raises.  There is no switch
and no fallback: on the card the kernel runs or the call raises.  No kernel
has a backward pass (no Pallas kernel of the JAX package has one either,
and ``jax.grad`` cannot differentiate them), so a CUDA call that autograd
would have to differentiate raises rather than return an output that
silently stops the gradient; on the CPU the plain versions are
differentiated as usual.  Each
kernel-backed op emits a THAPI ``ust_kernel:launch`` span with the same
analytic FLOPs and bytes as the JAX package's ``ops`` (so the spans compare);
eager PyTorch records one span per call where JAX records one per trace.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.interception import kernel_span

from . import flash_attention as _flash
from . import ref as _ref
from .rglru_scan import rglru_scan
from .ssd_scan import ssd_scan


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _no_grad_through(name: str, *inputs) -> None:
    """Raises when autograd records and an input requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward pass, as the JAX package's Pallas "
            "kernel has none; call it under torch.no_grad() or on inputs that need no gradient"
        )


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    B, S, H, hd = q.shape
    T = k.shape[1]
    flops = 4 * B * H * S * T * hd // (2 if causal else 1)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) * 2
    with kernel_span("flash_attention", (B, H, S), flops, nbytes):
        if _on_card(q):
            _no_grad_through("flash_attention", q, k, v)
            return _flash.flash_attention(q, k, v, causal=causal, window=window)
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rglru(x, r, i, lam, h0=None):
    B, S, C = x.shape
    flops = 6 * B * S * C
    nbytes = 3 * B * S * C * x.element_size()
    with kernel_span("rglru_scan", (B, S, C), flops, nbytes):
        if _on_card(x):
            _no_grad_through("rglru", x, r, i, lam, h0)
            return rglru_scan(x, r, i, lam, h0=h0)
        return _ref.rglru_ref(x, r, i, lam, h0=h0)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def ssd(x, dt, A_log, Bm, Cm, D, *, chunk: int = 64, state0=None):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    flops = B * S * H * (2 * P * N * 3 + 2 * 64 * P)  # states + intra approx
    nbytes = (x.numel() + Bm.numel() * 2) * x.element_size() * 2
    with kernel_span("ssd_scan", (B, H, S // chunk), flops, nbytes):
        if _on_card(x):
            _no_grad_through("ssd", x, dt, A_log, Bm, Cm, D, state0)
            return ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)
        return _ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)


# The JAX package has no TPU kernel for these three: plain PyTorch ops.


def rglru_step(h, x_t, r_t, i_t, lam):
    return _ref.rglru_step_ref(h, x_t, r_t, i_t, lam)


def ssd_step(state, x_t, dt_t, A_log, B_t, C_t, D):
    return _ref.ssd_step_ref(state, x_t, dt_t, A_log, B_t, C_t, D)


def causal_conv1d(x, w, state=None):
    return _ref.causal_conv1d_ref(x, w, state=state)
