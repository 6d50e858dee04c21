"""Dense decoder-only LM (llama / qwen / mistral / stablelm / h2o-danube
families), serving path.

Block: norm → GQA attention with RoPE (optionally a sliding window) →
residual → norm → SwiGLU MLP → residual.  The JAX package scans over the
stacked layer parameters; here a Python loop indexes layer ``l`` of each
stacked tensor.

Every prefill attention goes to ``kernels.ops.flash_attention`` (the
hand-written kernel on the card, ``ref.flash_attention_ref`` on the CPU).
The config's ``attn_impl`` / ``attn_chunk`` have no effect here: in the JAX
package they choose between the materialized ``attend`` and the blocked
``attend_chunked``, which stands in for the flash kernel in its dry-run.
Decode attends one query against the cache with ``layers.attend`` and a
``kv_len`` mask, as the JAX package does; the kernel takes no ``kv_len``.

The cache holds ``eff = min(cache_len, window)`` rows per layer (a ring
under a sliding window): prefill keeps the last ``eff`` post-RoPE keys and
values, rolled so that position ``p`` sits at row ``p % eff``, or fills rows
``[0, S)`` and zeros the rest when the prompt is shorter.
"""

from __future__ import annotations

import torch

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
    kv_cache_specs,
    layer_slice,
    mlp_specs,
    norm_spec,
    prefill_rows,
    qkv,
    unembed,
)


def specs(cfg: ModelConfig) -> dict:
    L = cfg.num_layers
    return {
        "embed": embed_specs(cfg),
        "blocks": {
            "attn": attn_specs(cfg, stacked=L),
            "mlp": mlp_specs(cfg, stacked=L),
            "ln1": norm_spec(cfg, stacked=L),
            "ln2": norm_spec(cfg, stacked=L),
        },
        "ln_f": norm_spec(cfg),
    }


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against a KV cache
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    return kv_cache_specs(cfg, batch, cache_len, cfg.num_layers)


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Run the prompt; returns last-position logits and a filled KV cache."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    ring = cfg.sliding_window is not None
    eff = min(cache_len, cfg.sliding_window) if ring else cache_len
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    ks, vs = [], []
    for l in range(cfg.num_layers):
        pl = layer_slice(params["blocks"], l)
        h = apply_norm(cfg, pl["ln1"], x)
        q, k, v = qkv(cfg, pl["attn"], h, positions)
        ctx = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
        x = x + attn_out(pl["attn"], ctx)
        h = apply_norm(cfg, pl["ln2"], x)
        x = x + apply_mlp(cfg, pl["mlp"], h)
        ks.append(prefill_rows(k, eff, ring))
        vs.append(prefill_rows(v, eff, ring))
    x = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = unembed(cfg, params["embed"], x)
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "len": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
    }
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One new token against the cache; returns (logits, cache).  The step
    writes the new K/V rows and the lengths into the cache it is handed and
    returns that same cache (the JAX engine donates it)."""
    token = batch["token"]  # [B]
    lengths = cache["len"]  # absolute number of tokens so far
    x = embed(params["embed"], token[:, None])
    positions = lengths[:, None]
    kv_valid = torch.clamp(lengths + 1, max=cache["k"].shape[2])
    for l in range(cfg.num_layers):
        pl = layer_slice(params["blocks"], l)
        h = apply_norm(cfg, pl["ln1"], x)
        q, k, v = qkv(cfg, pl["attn"], h, positions)
        ck, cv = cache["k"][l], cache["v"][l]
        cache_update(ck, cv, k, v, lengths, cfg.sliding_window)
        ctx = attend(q, ck, cv, causal=False, kv_len=kv_valid)
        x = x + attn_out(pl["attn"], ctx)
        h = apply_norm(cfg, pl["ln2"], x)
        x = x + apply_mlp(cfg, pl["mlp"], h)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x)
    lengths += 1
    return logits, cache
