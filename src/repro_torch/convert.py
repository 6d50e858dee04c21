"""Carry JAX parameter, train-state and cache trees across to the port's
tensors.

The JAX package keeps its weights as nested dicts and lists of arrays; the
port keeps the same nesting (for Mamba2 ``embed.tok/head``, ``blocks.{ln.w,
wz, wx, wB, wC, wdt, conv_w, A_log, D, dt_bias, norm_g, wo}``, ``ln_f.w``;
for RecurrentGemma ``groups.b<i>_<kind>`` and the ``tail`` list; for the
dense and VLM families ``embed.{tok,head}``, ``blocks.{attn.{wq,wk,wv,wo[,bq,bk,bv]},
mlp.{w_gate,w_up,w_down}, ln1, ln2}``, ``ln_f``; for the MoE family
``blocks.{attn, router, w_gate, w_up, w_down, ln1, ln2}``; for the
encoder–decoder ``pos_enc``, ``pos_dec``, ``enc_blocks.{attn,
mlp.{w_up,b_up,w_down,b_down}, ln1, ln2}``, ``ln_enc``, ``dec_blocks.{attn,
xattn.{wq,wk,wv,wo}, mlp, ln1, lnx, ln2}``) as torch tensors.  The trees
arrive with numpy leaves (``jax.device_get`` or ``np.asarray`` per leaf), so
this module needs no JAX; bf16 leaves arrive as ``ml_dtypes`` bfloat16 arrays and
keep their bits.
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
    if isinstance(np_tree, (list, tuple)):
        return [_tree(v, device) for v in np_tree]
    return _tensor(np_tree, device)


def params_from_jax(np_tree: dict, device) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's parameter dict."""
    return _tree(np_tree, torch.device(device))


def state_from_jax(np_tree: dict, device) -> dict:
    """A JAX train state (``params`` and ``opt.{mu, nu, count}``, numpy
    leaves) as the port's train state."""
    return _tree(np_tree, torch.device(device))


def cache_from_jax(np_tree: dict, device) -> dict:
    """A JAX serving cache (``conv``, ``state``, ``len``; ``groups``,
    ``tail``, ``len``; the dense and MoE ``k``, ``v``, ``len``; or the
    encoder–decoder's ``k``, ``v``, ``xk``, ``xv``, ``len``) as the port's
    cache."""
    return _tree(np_tree, torch.device(device))
