"""Dense decoder-only LM (llama / qwen / mistral / stablelm / h2o-danube
families) and the VLM prefix (llava-next: precomputed patch embeddings
prepended to the prompt): training forward and serving path.

Training (``block``, ``hidden_states``, ``forward_train``) is the JAX
package's: attention by ``layers.attend_cfg``, plain PyTorch that autograd
differentiates, and no kernel; the config's ``remat`` chooses what the
backward recomputes.  ``block`` takes its feed-forward, so that the MoE
family's training block is this one with the expert layer.

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

On a ``mesh`` every function takes the blocks of the split leaves
(``sharding.at_use``) and computes this rank's heads, KV heads, FFN
columns and vocabulary, as GSPMD partitions the JAX step (``layers``): the
prefill hands the flash kernel the rank's query heads with the KV heads
their groups read, the cache holds the rank's KV heads, and the serving
logits are gathered whole over "model".
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.kernels import ops as kops
from repro_torch.sharding.placement import at_use

from .config import ModelConfig
from .layers import (
    apply_mlp,
    gather_vocab,
    kv_for_heads,
    apply_norm,
    attend,
    attend_cfg,
    attn_out,
    attn_specs,
    cache_update,
    embed,
    embed_specs,
    kv_cache_specs,
    layer_slice,
    layer_slices,
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
# Training forward
# ---------------------------------------------------------------------------


#: the matrix products the port's models reach: projections and MLPs as
#: ``mm`` (or a ``bmm`` over a batch of one), attention and expert layers as ``bmm``
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: save the
    output of a matrix product that has no batch dimensions, recompute the
    rest.  The aten name does not say which products those are: an einsum
    ``"bsd,dhk->bshk"`` reaches a ``bmm`` over a batch of one, and the MoE
    family's ``"td,edf->tef"`` (no batch dimension: e is the weight's) a
    ``bmm`` whose token operand is broadcast over the experts (stride 0).
    A ``bmm`` whose operands both step along its batch is batched, as the
    attention einsums and the experts' down projection are.  An attention
    over one batch row and one KV head (B·Kv = 1, no config trains so)
    would reach a ``bmm`` over a batch of one and be saved."""
    if op in _PRODUCTS[:2]:
        return CheckpointPolicy.MUST_SAVE
    if op in _PRODUCTS[2:]:
        a, b = args[-2], args[-1]
        if a.shape[0] == 1 or a.stride(0) == 0 or b.stride(0) == 0:
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``remat="full"`` keeps only each block's inputs and recomputes the
    block in the backward pass (``jax.checkpoint``); ``"dots"`` also keeps
    the outputs of the block's matrix products without batch dimensions
    (``_dots_policy``); ``"none"`` keeps every activation."""
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    return fn


def _dense_ffn(cfg: ModelConfig, p: dict, h: torch.Tensor, mesh=None):
    return apply_mlp(cfg, p["mlp"], h, mesh), None


def block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, ffn=None, mesh=None):
    """One training block: returns (x, aux).  ``ffn(cfg, p, h) -> (y, aux)``
    is its feed-forward: the SwiGLU MLP (aux None; the default), or the MoE
    family's expert layer with its load-balance loss."""
    p = at_use(p)
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = qkv(cfg, p["attn"], h, positions)
    k, v = kv_for_heads(cfg, q, k, v, mesh)
    ctx = attend_cfg(cfg, q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn_out(p["attn"], ctx, cfg, mesh)
    h = apply_norm(cfg, p["ln2"], x)
    y, aux = _dense_ffn(cfg, p, h, mesh) if ffn is None else ffn(cfg, p, h)
    return x + y, aux


def hidden_states(cfg: ModelConfig, params: dict, x: torch.Tensor, positions: torch.Tensor, mesh=None) -> torch.Tensor:
    """The blocks in order (a loop over the layers where JAX scans), then
    the final norm."""
    body = _remat(cfg, lambda pl, h: block(cfg, pl, h, positions, mesh=mesh)[0])
    for pl in layer_slices(params["blocks"], cfg.num_layers):
        x = body(pl, x)
    return apply_norm(cfg, params["ln_f"], x)


def forward_train(cfg: ModelConfig, params: dict, batch: dict, mesh=None) -> torch.Tensor:
    """Logits ``[B, S, padded_vocab]`` over the whole sequence (this rank's
    vocabulary columns on a ``mesh``), after the patch embeddings where the
    config has vision tokens."""
    x = embed(params["embed"], batch["tokens"], cfg, mesh)
    if cfg.vision_tokens:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = hidden_states(cfg, params, x, positions, mesh)
    return unembed(cfg, params["embed"], x)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against a KV cache
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    return kv_cache_specs(cfg, batch, cache_len, cfg.num_layers)


def _dense_mlp(cfg: ModelConfig, pl: dict, h: torch.Tensor, mesh=None) -> torch.Tensor:
    return apply_mlp(cfg, pl["mlp"], h, mesh)


def prefill_layer(cfg: ModelConfig, pl: dict, x: torch.Tensor, positions: torch.Tensor, mlp=None, mesh=None):
    """One block over the prompt: returns (x, k, v) with the post-RoPE keys
    and values (this rank's KV heads on a ``mesh``).  ``mlp(cfg, pl, h)`` is
    the block's feed-forward (the MoE family passes its expert layer; the
    default is the dense MLP)."""
    pl = at_use(pl)
    h = apply_norm(cfg, pl["ln1"], x)
    q, k, v = qkv(cfg, pl["attn"], h, positions)
    kq, vq = kv_for_heads(cfg, q, k, v, mesh)
    ctx = kops.flash_attention(q, kq.contiguous(), vq.contiguous(), causal=True, window=cfg.sliding_window)
    x = x + attn_out(pl["attn"], ctx, cfg, mesh)
    h = apply_norm(cfg, pl["ln2"], x)
    return x + (_dense_mlp(cfg, pl, h, mesh) if mlp is None else mlp(cfg, pl, h)), k, v


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int, mlp=None, mesh=None):
    """Run the prompt, after ``batch["patch_embeds"]`` where the config has
    vision tokens; returns last-position logits (whole) and a filled KV
    cache."""
    x = embed(params["embed"], batch["tokens"], cfg, mesh)
    if cfg.vision_tokens:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    ring = cfg.sliding_window is not None
    eff = min(cache_len, cfg.sliding_window) if ring else cache_len
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for l in range(cfg.num_layers):
        x, k, v = prefill_layer(cfg, layer_slice(params["blocks"], l), x, positions, mlp, mesh)
        ks.append(prefill_rows(k, eff, ring))
        vs.append(prefill_rows(v, eff, ring))
    x = apply_norm(cfg, params["ln_f"], x[:, -1:])
    logits = gather_vocab(cfg, unembed(cfg, params["embed"], x), mesh)
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "len": torch.full((B,), S, dtype=torch.int32, device=x.device),
    }
    return logits, cache


def decode_layer(cfg: ModelConfig, pl: dict, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 lengths: torch.Tensor, kv_valid: torch.Tensor, mlp=None, mesh=None) -> torch.Tensor:
    """One block for one new token at position ``lengths``: writes its K/V
    into the layer's cache rows ``ck``/``cv`` in place and attends over the
    first ``kv_valid`` of them."""
    pl = at_use(pl)
    h = apply_norm(cfg, pl["ln1"], x)
    q, k, v = qkv(cfg, pl["attn"], h, lengths[:, None])
    cache_update(ck, cv, k, v, lengths, cfg.sliding_window)
    kq, vq = kv_for_heads(cfg, q, ck, cv, mesh)
    ctx = attend(q, kq, vq, causal=False, kv_len=kv_valid)
    x = x + attn_out(pl["attn"], ctx, cfg, mesh)
    h = apply_norm(cfg, pl["ln2"], x)
    return x + (_dense_mlp(cfg, pl, h, mesh) if mlp is None else mlp(cfg, pl, h))


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict, mlp=None, mesh=None):
    """One new token against the cache; returns (logits, cache), the logits
    whole.  The step writes the new K/V rows and the lengths into the cache
    it is handed and returns that same cache (the JAX engine donates it)."""
    lengths = cache["len"]  # absolute number of tokens so far
    x = embed(params["embed"], batch["token"][:, None], cfg, mesh)
    kv_valid = torch.clamp(lengths + 1, max=cache["k"].shape[2])
    for l in range(cfg.num_layers):
        pl = layer_slice(params["blocks"], l)
        x = decode_layer(cfg, pl, x, cache["k"][l], cache["v"][l], lengths, kv_valid, mlp, mesh)
    x = apply_norm(cfg, params["ln_f"], x)
    logits = gather_vocab(cfg, unembed(cfg, params["embed"], x), mesh)
    lengths += 1
    return logits, cache
