"""Carry JAX parameter and cache trees across to the port's tensors.

The JAX package keeps its weights as a nested dict of arrays; the port keeps
the same nesting (``embed.tok/head``, ``blocks.{ln.w, wz, wx, wB, wC, wdt,
conv_w, A_log, D, dt_bias, norm_g, wo}``, ``ln_f.w`` for Mamba2) as torch
tensors.  The trees arrive with numpy leaves (``jax.device_get`` or
``np.asarray`` per leaf), so this module needs no JAX; bf16 leaves arrive as
``ml_dtypes`` bfloat16 arrays and keep their bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(leaf, device) -> torch.Tensor:
    a = np.array(leaf)  # a writable copy: the port may update caches in place
    if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy support
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(np_tree, device):
    if isinstance(np_tree, dict):
        return {k: _tree(v, device) for k, v in np_tree.items()}
    return _tensor(np_tree, device)


def params_from_jax(np_tree: dict, device) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's parameter dict."""
    return _tree(np_tree, torch.device(device))


def cache_from_jax(np_tree: dict, device) -> dict:
    """A JAX serving cache (``conv``, ``state``, ``len``) as the port's cache."""
    return _tree(np_tree, torch.device(device))
