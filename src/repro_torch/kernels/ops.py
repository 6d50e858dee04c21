"""Dispatch wrappers the models call.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
PyTorch version in ``ref``; any other device raises.  There is no switch
and no fallback: on the card the kernel runs or the call raises.  Each
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
            return ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)
        return _ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)


# The JAX package has no TPU kernel for these three: plain PyTorch ops.


def rglru_step(h, x_t, r_t, i_t, lam):
    return _ref.rglru_step_ref(h, x_t, r_t, i_t, lam)


def ssd_step(state, x_t, dt_t, A_log, B_t, C_t, D):
    return _ref.ssd_step_ref(state, x_t, dt_t, A_log, B_t, C_t, D)


def causal_conv1d(x, w, state=None):
    return _ref.causal_conv1d_ref(x, w, state=state)
