"""The checks a kernel wrapper makes on the tensors it is handed."""

from __future__ import annotations

import torch


def check(
    kernel: str, name: str, t: torch.Tensor, shape: tuple, dtype, device, ref: str = "x"
) -> None:
    """Raise unless ``t`` is what the kernel takes: device, shape, dtype,
    contiguity.  ``ref`` names the input whose device the others must share."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, {ref} on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
