"""Learning-rate schedules: pure functions of the step, in fp32."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``floor·peak_lr``; ``step`` may be
    a number or a tensor (the optimizer's count, on its device)."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)
