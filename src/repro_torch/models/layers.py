"""Shared building blocks: RMSNorm and LayerNorm, RoPE, GQA attention
(materialized and blocked), the SwiGLU, GeGLU and biased GELU MLPs, the
(ring) KV cache, embeddings and the cross-entropy loss.

Pure functions on tensors (params in, tensors out), mirroring the JAX
package's ``models/layers.py``.  bf16 rounds where the JAX functions round:
the QKᵀ and PV products run in the input dtype, the softmax, RoPE and the
loss in fp32.  Every function here is plain PyTorch, so autograd
differentiates it: training runs ``attend_cfg`` as the JAX package's
``forward_train`` does, and no kernel.

On a mesh (``mesh``) a layer may hold this rank's block of its heads, KV
heads, FFN columns or vocabulary (``sharding.placement``: the leaves the
partitioner splits over "model"); each function reads the split from the
block's size against the config's and computes its own share: local heads
(``kv_for_heads`` picks the KV heads their groups read), a ``psum`` over
"model" after ``wo`` and ``w_down``, a masked local lookup and a ``psum``
for the embedding, local vocabulary columns from ``unembed`` and a
vocabulary-parallel log-sum-exp in ``xent_loss``.  A leaf that was not split
is whole on every rank, and the function computes it whole, as on one
device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C
from repro_torch.sharding.placement import Placed, block_range

from .config import ModelConfig
from .param import Spec


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with a zero-centred gain: scales by ``1 + w``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (biased variance), gain ``w`` and bias ``b``."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def norm_spec(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    if cfg.norm == "layernorm":
        return {
            "w": Spec(lead + (cfg.d_model,), lax + ("embed",), "ones"),
            "b": Spec(lead + (cfg.d_model,), lax + ("embed",), "zeros"),
        }
    return {"w": Spec(lead + (cfg.d_model,), lax + ("embed",), "zeros")}


def layer_slice(tree, l: int):
    """Layer ``l`` of a dict tree of layer-stacked tensors (of a sharded
    leaf, layer ``l`` of this rank's block, gathered where the block uses
    it: ``sharding.at_use``)."""
    if isinstance(tree, torch.Tensor):
        return tree[l]
    if isinstance(tree, Placed):
        return tree.layer(l)
    return {k: layer_slice(v, l) for k, v in tree.items()}


def layer_slices(tree, n: int) -> list:
    """``[layer_slice(tree, l) for l in range(n)]`` through one ``unbind``
    a leaf: under autograd each layer's gradient then lands in the stacked
    leaf by one ``stack``, where ``n`` indexings would each add a zero
    tensor of the whole stack."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, Placed):
        return tree.layers()
    per_key = {k: layer_slices(v, n) for k, v in tree.items()}
    return [{k: v[l] for k, v in per_key.items()} for l in range(n)]


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """The fp32 frequencies ``exp(-log(theta) k / half)``, ``k < half``, by
    the JAX formula, evaluated on the CPU for every device and kept per
    device.  Evaluated on an H100 they differ from the CPU's by up to 8 ulp
    (the argument rounds otherwise by up to an ulp, and ``exp`` scales its
    relative error by |argument| <= log(theta)), and the angle multiplies
    that by the position: at 5000 positions h2o-danube-1.8b's keys on the
    two devices parted by 1.9e-3."""
    freqs = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float32) / half)
    return freqs.to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] or [S] (absolute)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(theta, half, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; causal / window / decode)
# ---------------------------------------------------------------------------


def attend(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, Kv, hd]
    v: torch.Tensor,  # [B, T, Kv, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: Optional[torch.Tensor] = None,  # absolute position of q[., 0]
    kv_len: Optional[torch.Tensor] = None,  # valid prefix length of k/v
) -> torch.Tensor:
    """Grouped-query attention with the JAX ``attend``'s unified masking.

    ``q_offset`` positions the query block inside the key timeline (default
    ``T - S``); ``kv_len`` masks cache slots beyond the valid prefix.  Masked
    scores are -1e30 (not -inf), so a row with every key masked gets the
    uniform softmax, as in the reference.  fp32 softmax.
    """
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)

    qi = torch.arange(S, device=q.device)[:, None]  # [S, 1]
    kj = torch.arange(T, device=q.device)[None, :]  # [1, T]
    off = T - S if q_offset is None else q_offset
    qabs = qi + off  # absolute query positions
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qabs)
    if window is not None:
        mask = mask & (kj > qabs - window)
    mask_b = mask[None, :, :]
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1)
        mask_b = mask_b & (kj[None] < kvl)
    scores = torch.where(mask_b[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def attend_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 2048,
) -> torch.Tensor:
    """The JAX ``attend_chunked``: KV blocks of ``chunk`` rows with an online
    fp32 softmax, so the live score block is ``[S, chunk]``.  A ``T`` that
    ``chunk`` does not divide is one block."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if T % chunk:
        chunk = T
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))  # the JAX fp32 scale
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    m = torch.full((B, Kv, G, S), -1e30, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((B, Kv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, G, S, hd), dtype=torch.float32, device=q.device)
    for j0 in range(0, T, chunk):
        kc, vc = k[:, j0 : j0 + chunk], v[:, j0 : j0 + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kc).float() * scale
        kpos = j0 + torch.arange(chunk, device=q.device)[None, :]
        mask = torch.ones((S, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p.to(q.dtype), vc).float()
        m = m_new
    out = (acc / torch.clamp(lsum, min=1e-30)[..., None]).to(q.dtype)
    return out.movedim(3, 1).reshape(B, S, H, hd)


def kv_for_heads(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None):
    """K and V for this rank's query heads ``q [B, S, Hl, hd]``, laid out so
    that local query head i reads KV head ``i // (Hl / Kv')`` of the result,
    the contiguous GQA grouping of ``attend`` and the flash kernel: the global
    query head h reads global KV head ``h // (H / Kv)``.  ``k`` and ``v``
    hold the rank's block of the KV heads, or all of them where "kv_heads"
    was not split (then a slice, a view, or where the local heads' groups
    are uneven one KV head per query head).  Unsplit heads pass as they
    are."""
    H, Kv = cfg.padded_heads, cfg.padded_kv_heads
    Hl, Kvl = q.shape[2], k.shape[2]
    if Hl == H:
        return k, v
    h0, _ = block_range(H, Hl, mesh)
    kv0, _ = block_range(Kv, Kvl, mesh)
    G = H // Kv
    first = h0 // G - kv0
    if Hl % G == 0 and h0 % G == 0:
        n = Hl // G
    elif G % Hl == 0:  # every local head in one group: h0 is a multiple of Hl
        n = 1
    else:
        idx = torch.div(torch.arange(h0, h0 + Hl, device=k.device), G, rounding_mode="floor") - kv0
        return k.index_select(2, idx), v.index_select(2, idx)
    if first == 0 and n == Kvl:
        return k, v
    return k.narrow(2, first, n), v.narrow(2, first, n)


def attend_cfg(cfg: ModelConfig, q, k, v, *, causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Train attention by the config, as the JAX ``attend_cfg``: blocked when
    ``attn_impl`` is ``"chunked"`` and the keys outnumber ``attn_chunk``,
    else materialized."""
    if cfg.attn_impl == "chunked" and k.shape[1] > cfg.attn_chunk:
        return attend_chunked(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk)
    return attend(q, k, v, causal=causal, window=window)


def attn_specs(cfg: ModelConfig, stacked: Optional[int] = None, cross: bool = False) -> dict:
    d, H, Kv, hd = cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim_
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    s = {
        "wq": Spec(lead + (d, H, hd), lax + ("embed", "heads", "head_dim")),
        "wk": Spec(lead + (d, Kv, hd), lax + ("embed", "kv_heads", "head_dim")),
        "wv": Spec(lead + (d, Kv, hd), lax + ("embed", "kv_heads", "head_dim")),
        "wo": Spec(lead + (H, hd, d), lax + ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = Spec(lead + (H, hd), lax + ("heads", "head_dim"), "zeros")
        s["bk"] = Spec(lead + (Kv, hd), lax + ("kv_heads", "head_dim"), "zeros")
        s["bv"] = Spec(lead + (Kv, hd), lax + ("kv_heads", "head_dim"), "zeros")
    return s


def qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: Optional[torch.Tensor] = None):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _psum_split(y: torch.Tensor, local: int, whole: int, mesh) -> torch.Tensor:
    """``y`` summed over "model" when it is a partial product over a block of
    ``local`` of ``whole`` (the row-parallel product of a split leaf)."""
    return C.psum(y, mesh, "model") if mesh is not None and local < whole else y


def attn_out(p: dict, ctx: torch.Tensor, cfg: Optional[ModelConfig] = None, mesh=None) -> torch.Tensor:
    """The output projection; over this rank's heads on a ``mesh``, summed
    over "model"."""
    y = torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    return y if cfg is None else _psum_split(y, ctx.shape[2], cfg.padded_heads, mesh)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, stacked: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": Spec(lead + (d, ff), lax + ("embed", "mlp")),
            "w_up": Spec(lead + (d, ff), lax + ("embed", "mlp")),
            "w_down": Spec(lead + (ff, d), lax + ("mlp", "embed")),
        }
    return {
        "w_up": Spec(lead + (d, ff), lax + ("embed", "mlp")),
        "b_up": Spec(lead + (ff,), lax + ("mlp",), "zeros"),
        "w_down": Spec(lead + (ff, d), lax + ("mlp", "embed")),
        "b_down": Spec(lead + (d,), lax + ("embed",), "zeros"),
    }


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """SwiGLU, GeGLU, or (any other ``mlp_type``, as in the JAX package) the
    non-gated GELU MLP with biases.  ``jax.nn.gelu`` is the tanh
    approximation by default.  On a ``mesh`` over this rank's FFN columns,
    the down projection summed over "model" (the bias added once, after)."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp_type == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    y = _psum_split(h @ p["w_down"], h.shape[-1], cfg.d_ff, mesh)
    return y + p["b_down"] if "b_down" in p else y


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def kv_cache_specs(cfg: ModelConfig, batch: int, cache_len: int, layers: int) -> dict:
    """Layer-stacked K/V cache of ``eff = min(cache_len, window)`` rows (a
    ring under a sliding window) and the absolute length per batch row."""
    Kv, hd = cfg.padded_kv_heads, cfg.head_dim_
    eff = cache_len if cfg.sliding_window is None else min(cache_len, cfg.sliding_window)
    return {
        "k": Spec((layers, batch, eff, Kv, hd), ("layers", "batch", "seq", "kv_heads", "head_dim")),
        "v": Spec((layers, batch, eff, Kv, hd), ("layers", "batch", "seq", "kv_heads", "head_dim")),
        "len": Spec((batch,), ("batch",), "zeros", dtype="int32"),
    }


def prefill_rows(t: torch.Tensor, eff: int, ring: bool) -> torch.Tensor:
    """The ``eff`` cache rows a prefill of ``t [B,S,Kv,hd]`` leaves: rows
    ``[0, S)`` and zeros when the prompt is shorter, else the last ``eff``
    positions, rolled under a ring so that position ``p`` sits at row
    ``p % eff``."""
    S = t.shape[1]
    if S < eff:
        return F.pad(t, (0, 0, 0, 0, 0, eff - S))
    kept = t[:, -eff:]
    if ring and S > eff:
        kept = torch.roll(kept, S % eff, dims=1)
    return kept


def cache_update(cache_k, cache_v, k_new, v_new, lengths, window: Optional[int] = None) -> None:
    """Write one decode step's K/V at position ``lengths`` (a ring under a
    window) into the caches in place: the decode step owns the cache it is
    handed, as the JAX engine's donated one."""
    T = cache_k.shape[1]
    idx = lengths.long() % T if window is not None else torch.clamp(lengths.long(), max=T - 1)
    b = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k.index_put_((b, idx), k_new[:, 0])
    cache_v.index_put_((b, idx), v_new[:, 0])


def embed_specs(cfg: ModelConfig) -> dict:
    V, d = cfg.padded_vocab, cfg.d_model
    s = {"tok": Spec((V, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tied_embeddings:
        s["head"] = Spec((d, V), ("embed", "vocab"))
    return s


def embed(p: dict, tokens: torch.Tensor, cfg: Optional[ModelConfig] = None, mesh=None) -> torch.Tensor:
    """The rows of ``tokens``; over this rank's vocabulary rows on a
    ``mesh``, zeros for the others, summed over "model" (one rank adds
    each row, so the sum is the row, exactly)."""
    tok = p["tok"]
    if cfg is None or tok.shape[0] == cfg.padded_vocab:
        return tok[tokens]
    v0, n = block_range(cfg.padded_vocab, tok.shape[0], mesh)
    rel = tokens.long() - v0
    mine = (rel >= 0) & (rel < n)
    x = tok[torch.where(mine, rel, 0)] * mine[..., None].to(tok.dtype)
    return C.psum(x, mesh, "model")


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary columns this rank holds (all of them
    unless the vocabulary is split)."""
    if cfg.tied_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]


def gather_vocab(cfg: ModelConfig, logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """Logits over the whole vocabulary from this rank's columns (serving's
    argmax reads them whole, as the JAX step returns them unsharded)."""
    if mesh is None or logits.shape[-1] == cfg.padded_vocab:
        return logits
    return C.all_gather(logits, mesh, "model", dim=logits.ndim - 1)


def xent_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean cross-entropy over the real vocabulary: the padded columns are
    set to -1e30 in the logits' dtype, then logsumexp in fp32.  Over this
    rank's vocabulary columns on a ``mesh`` (a column's padding decided by
    its global index): the log-sum-exp from the ``pmax`` of the rows' maxima
    and the ``psum`` of their shifted sums, the gold logit from the rank
    that holds it, by a ``psum``."""
    V = cfg.vocab_size
    logits = logits[..., : cfg.padded_vocab]
    v0, n = block_range(cfg.padded_vocab, logits.shape[-1], mesh)
    if v0 + n > V:
        pad = torch.arange(v0, v0 + n, device=logits.device) >= V
        logits = logits.masked_fill(pad, -1e30)
    logits = logits.float()
    if n == cfg.padded_vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    top = C.pmax(logits.detach().amax(dim=-1), mesh, "model")
    logz = top + torch.log(C.psum(torch.exp(logits - top[..., None]).sum(dim=-1), mesh, "model"))
    rel = labels.long() - v0
    mine = (rel >= 0) & (rel < n)
    gold = torch.gather(logits, -1, torch.where(mine, rel, 0)[..., None])[..., 0]
    gold = C.psum(torch.where(mine, gold, 0.0), mesh, "model")
    return torch.mean(logz - gold)
