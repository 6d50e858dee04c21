"""Mixture-of-Experts LM (moonshot 64 experts / top-6, kimi-k2 384 / top-8):
training forward and serving path.

The block is the dense family's (``transformer.block`` in training,
attention by ``layers.attend_cfg`` and no kernel; ``prefill_layer`` /
``decode_layer`` in serving, every prefill attention through the flash
kernel) with the MLP replaced by the expert layer.  On one device the JAX
package's ``moe_ffn`` takes ``_moe_dense``: every expert on every token and
a masked combine of the router's top-k.  The port computes that function.
The expert products are batched matmuls over the expert axis whose token
operand is the tokens broadcast as a view, so nothing copies the
``[E, d, f]`` weights (an einsum over ``"td,edf->tef"`` copies); under
autograd the view's gradient is summed from ``[E, T, d]``.  The combine is a
scatter of the top-k weights into a ``[T, E]`` matrix, with static shapes
and no host sync, so the decode step captures as a CUDA graph.  The
router's expert shares (a scatter of ones) carry no gradient, as the JAX
one-hot carries none; the mean probabilities and the top-k weights do.

``forward_train`` returns the logits and the load-balance loss averaged
over the layers, summed in fp32 from an fp32 zero as the JAX scan's carry.
The expert-parallel path over a mesh (``shard_map`` / ``all_to_all``) is
not ported (ROADMAP.md §1 item 5).  MoE configs have no sliding window, so
the dense block's window is None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import transformer
from .config import ModelConfig
from .layers import (
    apply_norm,
    attn_specs,
    embed,
    embed_specs,
    kv_cache_specs,
    layer_slices,
    norm_spec,
    unembed,
)
from .param import Spec


def specs(cfg: ModelConfig) -> dict:
    L, d, E, ffe = cfg.num_layers, cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    return {
        "embed": embed_specs(cfg),
        "blocks": {
            "attn": attn_specs(cfg, stacked=L),
            "router": Spec((L, d, E), ("layers", "embed", None)),
            "w_gate": Spec((L, E, d, ffe), ("layers", "experts", "embed", "expert_mlp")),
            "w_up": Spec((L, E, d, ffe), ("layers", "experts", "embed", "expert_mlp")),
            "w_down": Spec((L, E, ffe, d), ("layers", "experts", "expert_mlp", "embed")),
            "ln1": norm_spec(cfg, stacked=L),
            "ln2": norm_spec(cfg, stacked=L),
        },
        "ln_f": norm_spec(cfg),
    }


def _router(cfg: ModelConfig, wr: torch.Tensor, xt: torch.Tensor):
    """Returns (weights [T,k] in x's dtype, expert ids [T,k], aux loss): an
    fp32 softmax over the experts, its top-k renormalised, and the switch
    load-balance loss E·Σ_e (share of assignments)·(mean probability)."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    probs = torch.softmax(xt.float() @ wr.float(), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    vals = vals / vals.sum(dim=-1, keepdim=True)
    ones = torch.ones(idx.numel(), dtype=torch.float32, device=xt.device)
    share = torch.zeros(E, dtype=torch.float32, device=xt.device).scatter_add_(0, idx.reshape(-1), ones)
    aux = E * torch.sum(share / xt.shape[0] * probs.mean(dim=0))
    return vals.to(xt.dtype), idx, aux


def _moe_dense(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """Every expert on every token, masked combine: ``[T, d]`` and the aux loss."""
    E = cfg.moe.num_experts
    T, d = xt.shape
    w, idx, aux = _router(cfg, p["router"], xt)
    xe = xt.expand(E, T, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])  # [E, T, f]
    y_all = torch.bmm(h, p["w_down"])  # [E, T, d]
    combine = torch.zeros((T, E), dtype=xt.dtype, device=xt.device).scatter_add_(1, idx, w)
    return torch.bmm(combine[:, None, :], y_all.transpose(0, 1))[:, 0], aux


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The JAX ``moe_ffn``'s mesh-free path: ``x [B,S,d]`` → (``[B,S,d]``, aux)."""
    B, S, d = x.shape
    out, aux = _moe_dense(cfg, p, x.reshape(-1, d))
    return out.reshape(B, S, d), aux


def _moe_mlp(cfg: ModelConfig, pl: dict, h: torch.Tensor) -> torch.Tensor:
    return moe_ffn(cfg, pl, h)[0]


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """The dense training block with the expert layer: (x, aux)."""
    return transformer.block(cfg, p, x, positions, ffn=moe_ffn)


def forward_train(cfg: ModelConfig, params: dict, batch: dict):
    """(logits ``[B, S, padded_vocab]``, the layers' mean load-balance loss)."""
    x = embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = transformer._remat(cfg, lambda pl, h: block(cfg, pl, h, positions))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pl in layer_slices(params["blocks"], cfg.num_layers):
        x, a = body(pl, x)
        aux = aux + a
    x = apply_norm(cfg, params["ln_f"], x)
    return unembed(cfg, params["embed"], x), aux / cfg.num_layers


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    return kv_cache_specs(cfg, batch, cache_len, cfg.num_layers)


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Run the prompt; returns last-position logits and a filled KV cache."""
    return transformer.prefill(cfg, params, batch, cache_len, mlp=_moe_mlp)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One new token; writes the cache it is handed in place and returns it."""
    return transformer.decode_step(cfg, params, cache, batch, mlp=_moe_mlp)
