"""Whisper-style encoder–decoder (audio backbone): training forward and
serving path.

As in the JAX package the conv frontend is a stub: ``batch["frames"]`` are
precomputed frame embeddings ``[B, enc_positions, d]``.  Pre-LN LayerNorm
blocks, non-gated GELU MLPs with biases, learned positional embeddings, a
full-attention encoder and a causal decoder with cross attention in every
layer.

``encode`` and ``_dec_block`` take the attention they run over a whole
sequence.  Training (``forward_train``) passes ``layers.attend``, plain
PyTorch that autograd differentiates, as the JAX package trains through
its ``attend``; each block is wrapped by the config's ``remat``.  Serving
keeps ``kernels.ops.flash_attention`` for every prefill attention: the
encoder's self-attention (non-causal), the decoder's self-attention
(causal) and its cross attention over the encoder states (non-causal).
Decode attends with ``layers.attend``, as the JAX package does.  Prefill
encodes the frames once and caches each layer's cross K/V (``xk``/``xv``)
beside the self-attention K/V; the decode step writes ``k``/``v``/``len``
in place and leaves ``xk``/``xv`` as they are.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.sharding.placement import at_use

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
    layer_slices,
    mlp_specs,
    norm_spec,
    prefill_rows,
    qkv,
    unembed,
)
from .param import Spec
from .transformer import _remat


def specs(cfg: ModelConfig) -> dict:
    L, Le, d = cfg.num_layers, cfg.encdec.enc_layers, cfg.d_model
    return {
        "embed": embed_specs(cfg),
        "pos_enc": Spec((cfg.encdec.enc_positions, d), (None, "embed"), scale=0.01),
        "pos_dec": Spec((cfg.encdec.dec_positions, d), (None, "embed"), scale=0.01),
        "enc_blocks": {
            "attn": attn_specs(cfg, stacked=Le),
            "mlp": mlp_specs(cfg, stacked=Le),
            "ln1": norm_spec(cfg, stacked=Le),
            "ln2": norm_spec(cfg, stacked=Le),
        },
        "ln_enc": norm_spec(cfg),
        "dec_blocks": {
            "attn": attn_specs(cfg, stacked=L),
            "xattn": attn_specs(cfg, stacked=L, cross=True),
            "mlp": mlp_specs(cfg, stacked=L),
            "ln1": norm_spec(cfg, stacked=L),
            "lnx": norm_spec(cfg, stacked=L),
            "ln2": norm_spec(cfg, stacked=L),
        },
        "ln_f": norm_spec(cfg),
    }


def _enc_block(cfg: ModelConfig, pl: dict, x: torch.Tensor, attention) -> torch.Tensor:
    pl = at_use(pl)
    q, k, v = qkv(cfg, pl["attn"], apply_norm(cfg, pl["ln1"], x))
    x = x + attn_out(pl["attn"], attention(q, k, v, causal=False))
    return x + apply_mlp(cfg, pl["mlp"], apply_norm(cfg, pl["ln2"], x))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, attention=kops.flash_attention,
           wrap=lambda fn: fn) -> torch.Tensor:
    """frames ``[B, T, d]`` → encoder states ``[B, T, d]``; ``wrap`` wraps
    each block (training passes the config's remat)."""
    x = frames + params["pos_enc"][None, : frames.shape[1]].to(frames.dtype)
    body = wrap(lambda pl, h: _enc_block(cfg, pl, h, attention))
    for pl in layer_slices(params["enc_blocks"], cfg.encdec.enc_layers):
        x = body(pl, x)
    return apply_norm(cfg, params["ln_enc"], x)


def _cross_kv(pl: dict, enc_out: torch.Tensor):
    pl = at_use(pl)
    k = torch.einsum("btd,dhk->bthk", enc_out, pl["xattn"]["wk"])
    v = torch.einsum("btd,dhk->bthk", enc_out, pl["xattn"]["wv"])
    return k, v


def _dec_block(cfg: ModelConfig, pl: dict, x, xk, xv, self_kv=None, lengths=None, kv_valid=None,
               attention=kops.flash_attention):
    """One decoder block over the cross K/V ``xk``/``xv``: the whole sequence
    through ``attention`` when ``self_kv`` is None, else one new token whose
    K/V go into the cache rows ``self_kv`` in place.  Returns (x, k, v)."""
    pl = at_use(pl)
    q, k, v = qkv(cfg, pl["attn"], apply_norm(cfg, pl["ln1"], x))
    if self_kv is None:
        ctx = attention(q, k, v, causal=True)
    else:
        ck, cv = self_kv
        cache_update(ck, cv, k, v, lengths)
        ctx = attend(q, ck, cv, causal=False, kv_len=kv_valid)
    x = x + attn_out(pl["attn"], ctx)
    qx = torch.einsum("bsd,dhk->bshk", apply_norm(cfg, pl["lnx"], x), pl["xattn"]["wq"])
    if self_kv is None:
        ctx = attention(qx, xk, xv, causal=False)
    else:
        ctx = attend(qx, xk, xv, causal=False)
    x = x + attn_out(pl["xattn"], ctx)
    return x + apply_mlp(cfg, pl["mlp"], apply_norm(cfg, pl["ln2"], x)), k, v


def forward_train(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Logits ``[B, S, padded_vocab]`` of the decoder over ``batch["tokens"]``
    after encoding ``batch["frames"]``, every attention by ``layers.attend``.
    The frames enter in the weights' dtype, as ``batch_specs`` declares them
    (the pipeline draws them in fp32; ROADMAP fault 28)."""
    frames = batch["frames"].to(params["pos_enc"].dtype)
    enc_out = encode(cfg, params, frames, attend, lambda fn: _remat(cfg, fn))
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens)
    x = x + params["pos_dec"][None, : tokens.shape[1]].to(x.dtype)

    def dec_block(pl, h, enc):
        xk, xv = _cross_kv(pl, enc)
        return _dec_block(cfg, pl, h, xk, xv, attention=attend)[0]

    body = _remat(cfg, dec_block)
    for pl in layer_slices(params["dec_blocks"], cfg.num_layers):
        x = body(pl, x, enc_out)
    x = apply_norm(cfg, params["ln_f"], x)
    return unembed(cfg, params["embed"], x)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    L, Kv, hd, T = cfg.num_layers, cfg.padded_kv_heads, cfg.head_dim_, cfg.encdec.enc_positions
    return {
        "k": Spec((L, batch, cache_len, Kv, hd), ("layers", "batch", "seq", "kv_heads", "head_dim")),
        "v": Spec((L, batch, cache_len, Kv, hd), ("layers", "batch", "seq", "kv_heads", "head_dim")),
        "xk": Spec((L, batch, T, Kv, hd), ("layers", "batch", None, "kv_heads", "head_dim")),
        "xv": Spec((L, batch, T, Kv, hd), ("layers", "batch", None, "kv_heads", "head_dim")),
        "len": Spec((batch,), ("batch",), "zeros", dtype="int32"),
    }


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Encode ``batch["frames"]`` and run the prompt; returns last-position
    logits and the cache (self K/V in rows ``[0, S)``, cross K/V whole)."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens) + params["pos_dec"][None, :S].to(enc_out.dtype)
    cache = {"k": [], "v": [], "xk": [], "xv": []}
    for l in range(cfg.num_layers):
        pl = layer_slice(params["dec_blocks"], l)
        xk, xv = _cross_kv(pl, enc_out)
        x, k, v = _dec_block(cfg, pl, x, xk, xv)
        for name, t in (("k", prefill_rows(k, cache_len, False)), ("v", prefill_rows(v, cache_len, False)),
                        ("xk", xk), ("xv", xv)):
            cache[name].append(t)
    x = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = unembed(cfg, params["embed"], x)
    cache = {name: torch.stack(ts) for name, ts in cache.items()}
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One new token; writes ``k``, ``v`` and ``len`` of the cache it is
    handed in place and returns that cache."""
    lengths = cache["len"]
    x = embed(params["embed"], batch["token"][:, None])
    pos = params["pos_dec"][torch.clamp(lengths, max=params["pos_dec"].shape[0] - 1)]
    x = x + pos[:, None].to(x.dtype)
    kv_valid = torch.clamp(lengths + 1, max=cache["k"].shape[2])
    for l in range(cfg.num_layers):
        pl = layer_slice(params["dec_blocks"], l)
        x, _, _ = _dec_block(cfg, pl, x, cache["xk"][l], cache["xv"][l], (cache["k"][l], cache["v"][l]),
                             lengths, kv_valid)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = unembed(cfg, params["embed"], x)
    lengths += 1
    return logits, cache
