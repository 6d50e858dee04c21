"""Dispatch wrappers the models call.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
PyTorch version in ``ref``; any other device raises.  There is no switch
and no fallback: on the card the kernel runs or the call raises.  Each
kernel-backed op emits a THAPI ``ust_kernel:launch`` span with the same
analytic FLOPs and bytes as the JAX package's ``ops`` (so the spans compare);
eager PyTorch records one span per call where JAX records one per trace.
"""

from __future__ import annotations

import torch

from repro_torch.core.interception import kernel_span

from . import ref as _ref
from .ssd_scan import ssd_scan


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


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


# The JAX package has no TPU kernel for these two: plain PyTorch ops.


def ssd_step(state, x_t, dt_t, A_log, B_t, C_t, D):
    return _ref.ssd_step_ref(state, x_t, dt_t, A_log, B_t, C_t, D)


def causal_conv1d(x, w, state=None):
    return _ref.causal_conv1d_ref(x, w, state=state)
