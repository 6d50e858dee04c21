"""Mamba2 (SSD — state-space duality) attention-free LM, serving path.

Block: RMSNorm → {z, x, B, C, dt} projections → causal depthwise conv on
(x|B|C) → SSD chunked scan (kernels.ops.ssd) → gated RMSNorm → out proj.
Decode carries (conv tail, SSM state) — O(1) in sequence length.

The JAX package scans over the stacked layer parameters; here a Python loop
indexes layer ``l`` of each stacked tensor.  The SSM state and the conv tail
are stored in the model dtype between steps, as in the JAX package, so a
bf16 model rounds them at the same places.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .config import ModelConfig
from .layers import embed, embed_specs, norm_spec, rmsnorm, unembed
from .param import Spec


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    conv_ch = di + 2 * s.n_groups * s.d_state
    return di, nh, s.n_groups, s.d_state, conv_ch


def specs(cfg: ModelConfig) -> dict:
    assert cfg.ssm is not None
    L, d = cfg.num_layers, cfg.d_model
    di, nh, G, N, conv_ch = _dims(cfg)
    K = cfg.ssm.d_conv
    return {
        "embed": embed_specs(cfg),
        "blocks": {
            "ln": norm_spec(cfg, stacked=L),
            "wz": Spec((L, d, di), ("layers", "embed", "channels")),
            "wx": Spec((L, d, di), ("layers", "embed", "channels")),
            "wB": Spec((L, d, G * N), ("layers", "embed", "state")),
            "wC": Spec((L, d, G * N), ("layers", "embed", "state")),
            "wdt": Spec((L, d, nh), ("layers", "embed", "ssm_heads")),
            "conv_w": Spec((L, K, conv_ch), ("layers", "conv", "channels")),
            "A_log": Spec((L, nh), ("layers", "ssm_heads"), "ssm_a"),
            "D": Spec((L, nh), ("layers", "ssm_heads"), "ones"),
            "dt_bias": Spec((L, nh), ("layers", "ssm_heads"), "ssm_dt"),
            "norm_g": Spec((L, di), ("layers", "channels"), "zeros"),
            "wo": Spec((L, di, d), ("layers", "channels", "embed")),
        },
        "ln_f": norm_spec(cfg),
    }


def _layer(tree, l: int):
    """Layer ``l`` of a tree of layer-stacked tensors."""
    if isinstance(tree, torch.Tensor):
        return tree[l]
    return {k: _layer(v, l) for k, v in tree.items()}


def _mix(cfg: ModelConfig, p: dict, h: torch.Tensor, conv_state=None):
    """Projections + conv; returns (z, xs, Bm, Cm, dt, new conv tail)."""
    di, nh, G, N, conv_ch = _dims(cfg)
    z = h @ p["wz"]
    xs = h @ p["wx"]
    Bm = h @ p["wB"]
    Cm = h @ p["wC"]
    dtl = h @ p["wdt"]
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    xbc, conv_tail = kops.causal_conv1d(xbc, p["conv_w"], state=conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dtl.float() + p["dt_bias"].float())
    return z, xs, Bm, Cm, dt, conv_tail


def _gate_out(p: dict, h: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm of the scan output, out projection, residual add."""
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_g"])
    return h + y @ p["wo"]


# ---------------------------------------------------------------------------
# Serving: recurrent state instead of a KV cache
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """State is O(1) in cache_len — the whole point of the SSM family."""
    L = cfg.num_layers
    di, nh, G, N, conv_ch = _dims(cfg)
    K = cfg.ssm.d_conv
    return {
        "conv": Spec((L, batch, K - 1, conv_ch), ("layers", "batch", None, "channels"), "zeros"),
        "state": Spec(
            (L, batch, nh, cfg.ssm.head_dim, N),
            ("layers", "batch", "ssm_heads", None, None),
            "zeros",
        ),
        "len": Spec((batch,), ("batch",), "zeros", dtype="int32"),
    }


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    tokens = batch["tokens"]
    di, nh, G, N, _ = _dims(cfg)
    B, S = tokens.shape
    P = cfg.ssm.head_dim
    h = embed(params["embed"], tokens)
    convs, states = [], []
    for l in range(cfg.num_layers):
        pl = _layer(params["blocks"], l)
        hn = rmsnorm(h, pl["ln"]["w"])
        z, xs, Bm, Cm, dt, conv_tail = _mix(cfg, pl, hn)
        # the split views are strided: the kernel takes contiguous tensors
        y, st = kops.ssd(
            xs.reshape(B, S, nh, P).contiguous(),
            dt,
            pl["A_log"],
            Bm.reshape(B, S, G, N).contiguous(),
            Cm.reshape(B, S, G, N).contiguous(),
            pl["D"],
            chunk=min(cfg.ssm.chunk, S),
        )
        h = _gate_out(pl, h, y.reshape(B, S, di), z)
        convs.append(conv_tail)
        states.append(st.to(h.dtype))
    h = rmsnorm(h, params["ln_f"]["w"])
    logits = unembed(cfg, params["embed"], h[:, -1:])
    cache = {
        "conv": torch.stack(convs),
        "state": torch.stack(states),
        "len": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
    }
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    token = batch["token"]
    di, nh, G, N, _ = _dims(cfg)
    B = token.shape[0]
    P = cfg.ssm.head_dim
    h = embed(params["embed"], token[:, None])
    convs, states = [], []
    for l in range(cfg.num_layers):
        pl = _layer(params["blocks"], l)
        hn = rmsnorm(h, pl["ln"]["w"])
        z, xs, Bm, Cm, dt, conv_tail = _mix(cfg, pl, hn, conv_state=cache["conv"][l])
        y, ssm_new = kops.ssd_step(
            cache["state"][l].float(),
            xs[:, 0].reshape(B, nh, P),
            dt[:, 0],
            pl["A_log"],
            Bm[:, 0].reshape(B, G, N),
            Cm[:, 0].reshape(B, G, N),
            pl["D"],
        )
        h = _gate_out(pl, h, y.reshape(B, 1, di), z)
        convs.append(conv_tail)
        states.append(ssm_new.to(h.dtype))
    h = rmsnorm(h, params["ln_f"]["w"])
    logits = unembed(cfg, params["embed"], h)
    return logits, {
        "conv": torch.stack(convs),
        "state": torch.stack(states),
        "len": cache["len"] + 1,
    }
