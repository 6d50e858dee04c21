"""Plain PyTorch versions of the kernels' functions (the oracles).

Mirrors ``src/repro/kernels/ref.py``: the CPU path runs these, the card's
kernels are held against them, and the tests hold them against the JAX
references.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Flash attention (causal / windowed GQA)
# ---------------------------------------------------------------------------


def flash_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Materialized-scores attention. q: [B,S,H,d], k/v: [B,T,Kv,d] → [B,S,H,d].

    The query at row i sits at position i + T - S.  Scores in fp32, masked
    to -1e30 (finite: a row with no unmasked key gets the uniform softmax,
    the mean of v over all T keys), softmax in fp32, probabilities cast to
    q's dtype before the PV product.
    """
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(hd)
    qi = torch.arange(S, device=q.device)[:, None] + (T - S)
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", p, v).reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


def rglru_scan_ref(a, b, h0=None):
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1. a, b: [B,S,C] → (h, h_last).

    A sequential fp32 loop over time: PyTorch has no associative scan, and a
    closed form through ``exp(-cumsum(log a))`` overflows on long prompts.
    ``h0`` enters as ``b_0 += a_0 · h0``.  Both results are fp32.
    """
    af = a.float()
    bf = b.float()
    h = torch.zeros_like(bf[:, 0]) if h0 is None else h0.float()
    out = torch.empty_like(bf)
    for t in range(af.shape[1]):
        h = torch.addcmul(bf[:, t], af[:, t], h)
        out[:, t] = h
    return out, h


def rglru_gates_ref(x, r, i, lam, c: float = 8.0):
    """RG-LRU gate math: a_t = exp(-c·softplus(Λ)·σ(r_t)); b_t = √(1-a²)·(σ(i_t)·x_t)."""
    log_a = -c * F.softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(i.float()) * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated
    return a, b


def rglru_ref(x, r, i, lam, h0=None, c: float = 8.0):
    """x, r, i: [B,S,C]; lam: [C]; h0: [B,C] or None →
    (y [B,S,C] in x's dtype, h_last [B,C] fp32)."""
    a, b = rglru_gates_ref(x, r, i, lam, c)
    h, h_last = rglru_scan_ref(a, b, h0)
    return h.to(x.dtype), h_last


def rglru_step_ref(h, x_t, r_t, i_t, lam, c: float = 8.0):
    """Single decode step: returns (y_t in x_t's dtype, h' fp32)."""
    a, b = rglru_gates_ref(x_t[:, None], r_t[:, None], i_t[:, None], lam, c)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked)
# ---------------------------------------------------------------------------


def ssd_ref(x, dt, A_log, Bm, Cm, D, chunk: int = 64, state0: Optional[torch.Tensor] = None):
    """Chunked SSD. Shapes:
      x: [B,S,H,P]  dt: [B,S,H] (post-softplus)  A_log: [H]
      Bm, Cm: [B,S,G,N]  D: [H]  state0: [B,H,P,N] or None
    Returns (y [B,S,H,P] in x's dtype, final state [B,H,P,N] fp32).
    """
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    if S % chunk:
        raise ValueError(f"seq {S} must divide chunk {chunk}")
    nc = S // chunk
    A = -torch.exp(A_log.float())  # [H]
    a = dt.float() * A  # [B,S,H] (log-decay per step)

    xf = x.float().reshape(Bsz, nc, chunk, H, Pd)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    af = a.reshape(Bsz, nc, chunk, H)
    # broadcast groups → heads
    Bh = Bm.float().reshape(Bsz, nc, chunk, G, N).repeat_interleave(hpg, dim=3)
    Ch = Cm.float().reshape(Bsz, nc, chunk, G, N).repeat_interleave(hpg, dim=3)

    cum = torch.cumsum(af, dim=2)  # [B,nc,L,H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,i,j,H]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    LT = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    # intra-chunk: y[i] = Σ_j C_i·B_j · L[i,j] · dt_j · x_j
    CB = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)  # [B,nc,i,j,H]
    W = CB * LT * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xf)
    # chunk-boundary states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,L,H]
    chunk_state = torch.einsum(
        "bclh,bclhn,bclhp->bchpn", dtf * decay_to_end, Bh, xf
    )  # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H]

    st = (
        torch.zeros(Bsz, H, Pd, N, dtype=torch.float32, device=x.device)
        if state0 is None
        else state0.float()
    )
    entering = []
    for c in range(nc):
        entering.append(st)  # state *entering* chunk c
        st = st * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    # inter-chunk contribution: y[i] += exp(cum_i) · C_i · state_entering
    y_inter = torch.einsum(
        "bclh,bclhn,bchpn->bclhp", torch.exp(cum), Ch, torch.stack(entering, dim=1)
    )
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), st


def ssd_step_ref(state, x_t, dt_t, A_log, B_t, C_t, D):
    """Single decode step.
      state: [B,H,P,N]  x_t: [B,H,P]  dt_t: [B,H]  B_t/C_t: [B,G,N]
    Returns (y_t [B,H,P], state').
    """
    H = x_t.shape[1]
    G = B_t.shape[1]
    hpg = H // G
    A = -torch.exp(A_log.float())
    da = torch.exp(dt_t.float() * A)  # [B,H]
    Bh = B_t.float().repeat_interleave(hpg, dim=1)  # [B,H,N]
    Ch = C_t.float().repeat_interleave(hpg, dim=1)
    xb = torch.einsum("bh,bhp,bhn->bhpn", dt_t.float(), x_t.float(), Bh)
    state = state.float() * da[:, :, None, None] + xb
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + x_t.float() * D.float()[None, :, None]
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (SSM temporal conv)
# ---------------------------------------------------------------------------


def causal_conv1d_ref(x, w, state=None):
    """x: [B,S,C], w: [K,C] depthwise causal conv.
    state: [B,K-1,C] trailing context (decode). Returns (y, new_state)."""
    K = w.shape[0]
    pad = (
        torch.zeros(x.shape[0], K - 1, x.shape[2], dtype=x.dtype, device=x.device)
        if state is None
        else state.to(x.dtype)
    )
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i : i + S] * w[i][None, None, :] for i in range(K))
    return y.to(x.dtype), xp[:, -(K - 1) :] if K > 1 else pad
