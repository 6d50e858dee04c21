"""The RG-LRU kernel's time-chunked scan and its tiling, mirrored in Python
from ``src/repro_torch/csrc/rglru_scan.cu`` for the tests.

The CPU tests (``test_torch_rglru_chunks.py``) hold the mirror against
``ref.rglru_ref`` and the JAX reference, and the tiling against a count of
every (b, step, channel); the card tests (``test_torch_rglru_cuda.py``) hold
the CUDA source's own plan to :func:`plan`.

The kernel's order of operations, per (b, channel):
  1. first walk: each thread's sub-chunk of ``TS`` steps forms (A, H) from
     h = 0, ``A = A * a_k`` and ``H = fma(a_k, H, b_k)``;
  2. a block's piece of ``CHUNK`` steps joins its ``SUBS`` sub-chunks in
     order, ``Hb = fma(A_q, Hb, H_q)`` and ``Ab = Ab * A_q`` (only when the
     launch has a cluster, K > 1);
  3. the cluster's K pieces of a round apply in order to the carry (h0 or
     zeros at first): piece q enters with the carry so far, then
     ``carry = fma(Ab_q, carry, Hb_q)``; with K = 1 the piece enters with h0;
  4. a sub-chunk enters with its piece's h and the piece's earlier
     sub-chunks applied in order, ``h = fma(A_q, h, H_q)``;
  5. second walk: ``h = fma(a_k, h, b_k)`` from that h, the plain order; y is
     h in x's dtype, h_last the h at step S - 1.
For S <= ``TS`` the kernel takes its step kernel, which walks all steps
from h0 in the plain order: what the order above gives with the one
sub-chunk.  The gates are ``ref.rglru_gates_ref`` (the kernel evaluates the
same fp32 formula, with IEEE division and square root and the accurate exp
and log1p).  :func:`fma` rounds once, as the card's FMA does (the exact
product and sum in float64, then fp32; float64 inputs stay float64).

Pure Python, imported by its file name (pytest puts ``tests/`` on the path),
so that it also loads where another installed package is named ``tests``.
"""

import torch

from repro_torch.kernels import ref

#: 16-byte channel groups of a tile; sub-chunks of a block; steps of a
#: sub-chunk; steps of a block's piece; blocks of a cluster along time
LANES, SUBS, TS, MAX_CLUSTER = 8, 16, 8, 8
CHUNK = SUBS * TS
THREADS = LANES * SUBS
#: channels (one a thread) of a block of the step kernel, which takes S <= TS
STEP_THREADS = 128


def channels_per_lane(dtype: torch.dtype) -> int:
    """Channels of one 16-byte vector: 8 bf16 or 4 fp32."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block: a and b of every thread's sub-chunk, fp32."""
    return 2 * 4 * TS * THREADS * channels_per_lane(dtype)


def static_smem_bytes(dtype: torch.dtype) -> int:
    """Static shared memory of a block: the sub-chunks' (A, H), the piece's
    (A, H) by round parity, the carry and the piece's entering h, fp32."""
    tile = LANES * channels_per_lane(dtype)
    return 4 * tile * (2 * SUBS + 2 * 2 + 2)


def plan(dtype: torch.dtype, B: int, S: int, C: int, max_cluster: int = MAX_CLUSTER) -> dict:
    """The launch's kernel and tiling, keyed as ``rglru_scan.kernel_plan``
    returns them: the step kernel for S <= TS, else the chunked one."""
    pieces = -(-S // CHUNK)
    K = min(max_cluster, pieces)
    step = S <= TS
    tile = STEP_THREADS if step else LANES * channels_per_lane(dtype)
    return {
        "step": int(step),
        "cluster": K,
        "rounds": -(-pieces // K),
        "tile": tile,
        "grid_x": K * -(-C // tile),
        "grid_y": B,
        "threads": STEP_THREADS if step else THREADS,
        "sub_steps": TS,
        "chunk": CHUNK,
        "smem": 0 if step else smem_bytes(dtype),
    }


def thread_work(p: dict, S: int, C: int, bx: int, tid: int, rd: int) -> tuple:
    """(steps, channels) that thread ``tid`` of block x ``bx`` walks in round
    ``rd``, as the kernel indexes them: empty ranges past S or C."""
    if p["step"]:  # one channel a thread, every step
        c = bx * STEP_THREADS + tid
        return (range(0, S), range(c, c + 1)) if c < C else (range(0), range(0))
    K, tile = p["cluster"], p["tile"]
    n_ch = tile // LANES
    lane, sub = tid % LANES, tid // LANES
    rank, tile_idx = bx % K, bx // K
    c0 = tile_idx * tile + lane * n_ch
    t0 = (rd * K + rank) * CHUNK + sub * TS
    channels = range(c0, max(c0, min(c0 + n_ch, C)))
    steps = range(t0, max(t0, min(t0 + TS, S))) if len(channels) else range(t0, t0)
    return steps, channels


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once: the fp32 product is exact in float64."""
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def rglru_chunks(x, r, i, lam, h0=None, *, max_cluster: int = MAX_CLUSTER, gates=None):
    """x, r, i ``[B,S,C]``; lam ``[C]``; h0 ``[B,C]`` or None → (y in x's
    dtype, h_last fp32), in the kernel's order.  ``gates`` (a, b) replaces
    the gate math, e.g. with float64 gates; the scan then runs in their
    dtype."""
    a, b = ref.rglru_gates_ref(x, r, i, lam) if gates is None else gates
    B, S, C = a.shape
    p = plan(x.dtype, B, S, C, max_cluster)
    K, R = p["cluster"], p["rounds"]
    T = R * K * CHUNK
    # steps past S are the identity (A = 1, H = 0), as the kernel skips them
    a_p = torch.ones(B, T, C, dtype=a.dtype)
    b_p = torch.zeros(B, T, C, dtype=a.dtype)
    a_p[:, :S], b_p[:, :S] = a, b
    a_p = a_p.reshape(B, R, K, SUBS, TS, C)
    b_p = b_p.reshape(B, R, K, SUBS, TS, C)

    A = torch.ones(B, R, K, SUBS, C, dtype=a.dtype)  # 1. each sub-chunk's (A, H)
    H = torch.zeros_like(A)
    for k in range(TS):
        A = A * a_p[..., k, :]
        H = fma(a_p[..., k, :], H, b_p[..., k, :])
    Ab = torch.ones(B, R, K, C, dtype=a.dtype)  # 2. each piece's (A, H)
    Hb = torch.zeros_like(Ab)
    for q in range(SUBS):
        Hb = fma(A[:, :, :, q], Hb, H[:, :, :, q])
        Ab = Ab * A[:, :, :, q]
    carry = torch.zeros(B, C, dtype=a.dtype) if h0 is None else h0.to(a.dtype)
    h_piece = torch.empty(B, R, K, C, dtype=a.dtype)  # 3. the h entering each piece
    for rd in range(R):
        for q in range(K):
            h_piece[:, rd, q] = carry
            carry = fma(Ab[:, rd, q], carry, Hb[:, rd, q])
    h = h_piece  # 4. the h entering each sub-chunk
    h_sub = torch.empty_like(A)
    for q in range(SUBS):
        h_sub[:, :, :, q] = h
        h = fma(A[:, :, :, q], h, H[:, :, :, q])
    h = h_sub  # 5. the second walk
    ys = torch.empty_like(a_p)
    for k in range(TS):
        h = fma(a_p[..., k, :], h, b_p[..., k, :])
        ys[..., k, :] = h
    ys = ys.reshape(B, T, C)[:, :S]
    return ys.to(x.dtype) if gates is None else ys, ys[:, -1].clone()


def sequential(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """The plain order with one rounding per step: h_t = fma(a_t, h_{t-1}, b_t)."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.to(a.dtype)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = fma(a[:, t], h, b[:, t])
        out[:, t] = h
    return out
