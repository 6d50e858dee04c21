"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention,
serving path.

Block pattern (rec, rec, attn) repeats; 26 layers = 8 full groups + 2
trailing recurrent blocks.  Full groups keep stacked parameters (a Python
loop indexes group ``l``, where the JAX package scans); the remainder is the
``tail`` list.

Recurrent block: ln → [gate: W_gate→GeLU] ⊙ [W_x → causal conv1d → RG-LRU
(kernels.ops.rglru)] → W_o, followed by a GeGLU MLP sub-block.  RG-LRU gates
are block-diagonal (cfg.num_heads blocks).  Attention block: GQA (kv=1) with
RoPE and a local window.

Decode state: per rec block (conv tail [K-1, w], h [w]); per attn block a
ring KV cache of ``eff = min(cache_len, local_window)`` rows.  The JAX
package sizes the engine's ring at the window whatever ``cache_len`` is, so
its engine cannot splice a prefill row when ``cache_len`` is shorter; the
port sizes it at ``eff``, which is what prefill writes and decode reads.

``h`` leaves the RG-LRU in fp32, so a decode step hands back an fp32 ``h``
whatever the cache held before (the JAX package does the same).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .config import ModelConfig
from .layers import (
    apply_mlp,
    apply_norm,
    attend,
    attn_out,
    attn_specs,
    cache_update,
    embed,
    embed_specs,
    layer_slice,
    mlp_specs,
    norm_spec,
    prefill_rows,
    qkv,
    unembed,
)
from .param import Spec


def _w(cfg: ModelConfig) -> int:
    return cfg.rglru.width or cfg.d_model


def _nb(cfg: ModelConfig) -> int:
    return max(cfg.num_heads, 1)  # RG-LRU block-diagonal head count


def rec_specs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, w, nb = cfg.d_model, _w(cfg), _nb(cfg)
    bs = w // nb
    K = cfg.rglru.d_conv
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    return {
        "w_gate": Spec(lead + (d, w), lax + ("embed", "channels")),
        "w_x": Spec(lead + (d, w), lax + ("embed", "channels")),
        "conv_w": Spec(lead + (K, w), lax + ("conv", "channels")),
        "w_r": Spec(lead + (nb, bs, bs), lax + ("channels", None, None)),
        "b_r": Spec(lead + (w,), lax + ("channels",), "zeros"),
        "w_i": Spec(lead + (nb, bs, bs), lax + ("channels", None, None)),
        "b_i": Spec(lead + (w,), lax + ("channels",), "zeros"),
        "lam": Spec(lead + (w,), lax + ("channels",), "lru_a"),
        "w_o": Spec(lead + (w, d), lax + ("channels", "embed")),
    }


def _block_specs(cfg: ModelConfig, kind: str, stacked: int = 0) -> dict:
    s = {
        "ln1": norm_spec(cfg, stacked=stacked or None),
        "ln2": norm_spec(cfg, stacked=stacked or None),
        "mlp": mlp_specs(cfg, stacked=stacked or None),
    }
    if kind == "rec":
        s["rec"] = rec_specs(cfg, stacked)
    else:
        s["attn"] = attn_specs(cfg, stacked=stacked or None)
    return s


def layout(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, full groups, remainder kinds)."""
    pat = cfg.rglru.pattern
    g, r = divmod(cfg.num_layers, len(pat))
    return pat, g, pat[:r]


def specs(cfg: ModelConfig) -> dict:
    assert cfg.rglru is not None
    pat, g, rem = layout(cfg)
    return {
        "embed": embed_specs(cfg),
        "groups": {f"b{i}_{kind}": _block_specs(cfg, kind, stacked=g) for i, kind in enumerate(pat)},
        "tail": [_block_specs(cfg, kind) for kind in rem],
        "ln_f": norm_spec(cfg),
    }


# ---------------------------------------------------------------------------
# Block applications
# ---------------------------------------------------------------------------


def _blockdiag(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: [B,S,w] → block-diagonal linear with W [nb, bs, bs]."""
    B, S, w = x.shape
    nb, bs, _ = W.shape
    y = torch.einsum("bsnk,nkj->bsnj", x.reshape(B, S, nb, bs), W)
    return y.reshape(B, S, w) + b


def rec_mix(cfg: ModelConfig, p: dict, h: torch.Tensor, state=None):
    """RG-LRU temporal mixer. state: None | (conv_tail, h_rec)."""
    gate = F.gelu(h @ p["w_gate"], approximate="tanh")  # jax.nn.gelu's default
    xs = h @ p["w_x"]
    conv_state = None if state is None else state[0]
    xs, conv_tail = kops.causal_conv1d(xs, p["conv_w"], state=conv_state)
    r = _blockdiag(xs, p["w_r"], p["b_r"])
    i = _blockdiag(xs, p["w_i"], p["b_i"])
    h0 = None if state is None else state[1]
    y, h_last = kops.rglru(xs, r, i, p["lam"], h0=h0)
    y = y * gate
    return y @ p["w_o"], (conv_tail, h_last)


def _stack(states: List[dict]) -> dict:
    """Per-group block states → one dict of group-stacked tensors."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _rec_state_specs(cfg: ModelConfig, batch: int, stacked: int = 0) -> dict:
    w, K = _w(cfg), cfg.rglru.d_conv
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    return {
        "conv": Spec(lead + (batch, K - 1, w), lax + ("batch", None, "channels"), "zeros"),
        "h": Spec(lead + (batch, w), lax + ("batch", "channels"), "zeros"),
    }


def _attn_cache_specs(cfg: ModelConfig, batch: int, eff: int, stacked: int = 0) -> dict:
    Kv, hd = cfg.padded_kv_heads, cfg.head_dim_
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    kv = Spec(lead + (batch, eff, Kv, hd), lax + ("batch", "seq", "kv_heads", "head_dim"), "zeros")
    return {"k": kv, "v": kv}


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    pat, g, rem = layout(cfg)
    eff = min(cache_len, cfg.rglru.local_window)

    def block(kind: str, stacked: int = 0) -> dict:
        if kind == "rec":
            return _rec_state_specs(cfg, batch, stacked)
        return _attn_cache_specs(cfg, batch, eff, stacked)

    return {
        "groups": {f"b{i}_{kind}": block(kind, g) for i, kind in enumerate(pat)},
        "tail": [block(kind) for kind in rem],
        "len": Spec((batch,), ("batch",), "zeros", dtype="int32"),
    }


def _prefill_block(cfg, kind, p, x, positions, eff):
    """Apply block and return its serving state."""
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "rec":
        y, (conv_tail, h_last) = rec_mix(cfg, p["rec"], h)
        x = x + y
        st = {"conv": conv_tail, "h": h_last}
    else:
        q, k, v = qkv(cfg, p["attn"], h, positions)
        ctx = attend(q, k, v, causal=True, window=cfg.rglru.local_window)
        x = x + attn_out(p["attn"], ctx)
        st = {"k": prefill_rows(k, eff, ring=True), "v": prefill_rows(v, eff, ring=True)}
    h = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["mlp"], h), st


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    tokens = batch["tokens"]
    B, S = tokens.shape
    eff = min(cache_len, cfg.rglru.local_window)
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    pat, g, rem = layout(cfg)
    keys = [f"b{i}_{kind}" for i, kind in enumerate(pat)]
    states = {key: [] for key in keys}
    for l in range(g):
        pg = layer_slice(params["groups"], l)
        for key, kind in zip(keys, pat):
            x, st = _prefill_block(cfg, kind, pg[key], x, positions, eff)
            states[key].append(st)
    groups_cache = {key: _stack(states[key]) for key in keys} if g else {}
    tail_cache = []
    for kind, p in zip(rem, params["tail"]):
        x, st = _prefill_block(cfg, kind, p, x, positions, eff)
        tail_cache.append(st)
    x = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = unembed(cfg, params["embed"], x)
    return logits, {
        "groups": groups_cache,
        "tail": tail_cache,
        "len": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
    }


def _decode_block(cfg, kind, p, x, lengths, st):
    """Apply block to one new token, writing its serving state ``st`` in place."""
    positions = lengths[:, None]
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "rec":
        y, (conv_tail, h_new) = rec_mix(cfg, p["rec"], h, state=(st["conv"], st["h"]))
        x = x + y
        st["conv"].copy_(conv_tail)
        st["h"].copy_(h_new)
    else:
        q, k, v = qkv(cfg, p["attn"], h, positions)
        cache_update(st["k"], st["v"], k, v, lengths, cfg.rglru.local_window)
        kv_valid = torch.clamp(lengths + 1, max=st["k"].shape[1])
        ctx = attend(q, st["k"], st["v"], causal=False, kv_len=kv_valid)
        x = x + attn_out(p["attn"], ctx)
    h = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def _h_to_fp32(cache: dict) -> None:
    """``rec_mix`` returns h in fp32 where the cache declares the model dtype
    (as in the JAX package): the first decode step turns each h leaf into
    fp32, as the JAX one's output does, and later steps write it in place."""
    states = [st for key, st in cache["groups"].items() if key.endswith("_rec")]
    for st in states + [st for st in cache["tail"] if "h" in st]:
        if st["h"].dtype != torch.float32:
            st["h"] = st["h"].float()


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One new token; writes every block's state and the lengths into the
    cache it is handed and returns that same cache (the JAX engine donates
    it)."""
    token = batch["token"]
    lengths = cache["len"]
    _h_to_fp32(cache)
    x = embed(params["embed"], token[:, None])
    pat, g, rem = layout(cfg)
    keys = [f"b{i}_{kind}" for i, kind in enumerate(pat)]
    for l in range(g):
        pg, cg = layer_slice(params["groups"], l), layer_slice(cache["groups"], l)
        for key, kind in zip(keys, pat):
            x = _decode_block(cfg, kind, pg[key], x, lengths, cg[key])
    for kind, p, st in zip(rem, params["tail"], cache["tail"]):
        x = _decode_block(cfg, kind, p, x, lengths, st)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x)
    lengths += 1
    return logits, cache
