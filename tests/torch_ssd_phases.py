"""The bf16 SSD kernel's three passes and its tiling, mirrored in Python from
``src/repro_torch/csrc/ssd_scan.cu`` for the tests.

The CPU tests (``test_torch_ssd_phases.py``) hold the passes against
``ref.ssd_ref`` and the JAX reference, and the tiling against a brute-force
causal mask; the card tests (``test_torch_ssd_cuda.py``) hold the CUDA
source's own tiling values to this mirror.

The passes, per (batch, head) and chunk of L rows:
  1. chunk pass: cum = cumsum of dt*A over the chunk, w_j = dt_j exp(cum_L -
     cum_j), and the chunk's own state  sum_j (x_j w_j) B_j^T  [P, N];
  2. state pass: state_{c+1} = state_c exp(cum_L,c) + chunk_state_c from
     state0 (or zeros), keeping the state entering each chunk;
  3. output pass, per 64-row tile: exp(cum_i) C_i . entering^T, plus
     sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j, plus D x_i.
With ``split=True`` each fp32 operand the tensor cores take (x*w, the
entering state and W) is rounded where the kernel rounds it: to a bf16 high
part plus a bf16 low part, two products.  ``split=False`` keeps fp32.  The
passes compute in fp32, or in float64 for float64 inputs (the yardstick of
the fp32 sums' own rounding).

Pure Python, imported by its file name (pytest puts ``tests/`` on the path),
so that it also loads where another installed package is named ``tests``.
"""

import torch

#: rows of one tile (output pass) and of one slice (chunk pass); longest
#: chunk; threads per block (one warpgroup)
TILE, MAX_CHUNK, THREADS = 64, 256, 128
#: the kernel's compile-time head width and state size
P, N = 64, 128
#: dynamic shared memory a block may have with two blocks on an SM: the
#: SM's 233,472 bytes less 1 KB reserved per block, halved
TWO_BLOCKS_SMEM = (233_472 - 2 * 1024) // 2


def tiles(L: int) -> int:
    """64-row tiles of a chunk of L rows."""
    return -(-L // TILE)


def smem_bytes() -> dict:
    """Dynamic shared memory of each pass's block, as the CUDA source sizes
    it (bf16 tiles of 64 rows; 1 KB to align the base to the swizzle)."""
    tile_bn = TILE * N * 2  # 64 rows x 128 bf16: a B, C or state tile
    tile_xp = TILE * P * 2  # 64 rows x 64 bf16: an x tile
    return {
        # a B slice (swizzled), an x slice with rows padded to 72 bf16, cum and w
        "chunk": tile_bn + TILE * (P + 8) * 2 + 2 * MAX_CHUNK * 4 + 1024,
        "state": 0,
        # the C tile, two stages of (B, x), cum and dt; the entering state's
        # high and low parts come in through the two B stages
        "output": tile_bn + 2 * (tile_bn + tile_xp) + 2 * MAX_CHUNK * 4 + 1024,
    }


def grids(B: int, S: int, H: int, L: int) -> dict:
    """Each pass's grid (x, y, z) and its threads per block."""
    nc = S // L
    return {
        "chunk": ((nc, H, B), THREADS),
        "state": ((P * N // 256, H, B), 256),
        "output": ((nc * tiles(L), H, B), THREADS),
    }


def output_tiles(L: int, t: int) -> list:
    """The source tiles (first row of each) that output tile ``t`` of a chunk
    of L rows multiplies in: those at or below the diagonal."""
    return [jt * TILE for jt in range(t + 1)]


def stored_rows(L: int, t: int) -> range:
    """The rows output tile ``t`` stores: none past the chunk's end."""
    return range(t * TILE, min((t + 1) * TILE, L))


def _split(t: torch.Tensor) -> torch.Tensor:
    """fp32 as the sum of its bf16 high and low parts (two tensor-core
    operands)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _work(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the passes' working type: fp32, or float64 for float64."""
    return t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """[B, nc, L, G, N] groups broadcast to heads: [B, nc, L, H, N]."""
    return t.repeat_interleave(H // t.shape[3], dim=3)


def chunk_pass(x, dt, A_log, Bm, chunk: int, split: bool):
    """(cum [B, nc, L, H], chunk_state [B, nc, H, P, N]) in the working type."""
    Bsz, S, H, Pd = x.shape
    G, Nd = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    A = -torch.exp(_work(A_log))
    dtf = _work(dt).reshape(Bsz, nc, chunk, H)
    cum = torch.cumsum(dtf * A, dim=2)
    w = dtf * torch.exp(cum[:, :, -1:] - cum)
    xw = _work(x).reshape(Bsz, nc, chunk, H, Pd) * w[..., None]
    if split:
        xw = _split(xw)
    Bh = _heads(_work(Bm).reshape(Bsz, nc, chunk, G, Nd), H)
    return cum, torch.einsum("bclhp,bclhn->bchpn", xw, Bh)


def state_pass(chunk_state, cum, state0=None):
    """(the state entering each chunk [B, nc, H, P, N], the final state)."""
    Bsz, nc, H, Pd, Nd = chunk_state.shape
    st = torch.zeros_like(chunk_state[:, 0]) if state0 is None else state0.to(chunk_state.dtype)
    entering = []
    for c in range(nc):
        entering.append(st)
        st = st * torch.exp(cum[:, c, -1])[:, :, None, None] + chunk_state[:, c]
    return torch.stack(entering, dim=1), st


def output_pass(x, dt, Bm, Cm, D, cum, entering, split: bool):
    """y [B, S, H, P] in the working type."""
    Bsz, S, H, Pd = x.shape
    G, Nd = Bm.shape[2], Bm.shape[3]
    nc, L = cum.shape[1], cum.shape[2]
    xf = _work(x).reshape(Bsz, nc, L, H, Pd)
    dtf = _work(dt).reshape(Bsz, nc, L, H)
    Bh = _heads(_work(Bm).reshape(Bsz, nc, L, G, Nd), H)
    Ch = _heads(_work(Cm).reshape(Bsz, nc, L, G, Nd), H)
    # exp(cum_i - cum_j) per element, and only where j <= i (above the
    # diagonal it may overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool))[None, None, :, :, None]
    W = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * torch.where(causal, torch.exp(seg), 0.0)
    W = W * dtf[:, :, None, :, :]
    ent = entering
    if split:
        W, ent = _split(W), _split(entering)
    y = torch.einsum("bcijh,bcjhp->bcihp", W, xf)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bclhn,bchpn->bclhp", Ch, ent)
    return y.reshape(Bsz, S, H, Pd) + xf.reshape(Bsz, S, H, Pd) * _work(D)[None, None, :, None]


def ssd_phases(x, dt, A_log, Bm, Cm, D, *, chunk: int, state0=None, split: bool = False):
    """The three passes end to end: (y in x's dtype, final state in the
    working type)."""
    cum, chunk_state = chunk_pass(x, dt, A_log, Bm, chunk, split)
    entering, final = state_pass(chunk_state, cum, state0)
    y = output_pass(x, dt, Bm, Cm, D, cum, entering, split)
    return y.to(x.dtype), final
