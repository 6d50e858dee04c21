"""Plain PyTorch versions of the kernels' functions (the oracles).

Mirrors ``src/repro/kernels/ref.py`` for the SSM slice: the CPU path runs
these, the card's kernels are held against them, and the tests hold them
against the JAX references.
"""

from __future__ import annotations

from typing import Optional

import torch

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
