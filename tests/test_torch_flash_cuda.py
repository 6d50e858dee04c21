"""On a CUDA card: the hand-written flash-attention kernel against its plain
version.

The kernel has no CPU mode, so every case carries the ``cuda`` marker and
skips without a card.  This file imports neither JAX nor the JAX package, so
it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

Tolerances: fp32 2e-5 at the small shapes and 1e-4 from S = 256 up (the
same fp32 arithmetic in another order, summed over up to 1024 keys); bf16
2e-2 (both round the probabilities to bf16 before PV; the kernel keeps its
scores in fp32 where the plain version's bf16 product rounds them, and it
rounds unnormalised probabilities where the plain version rounds
normalised ones).

bf16 runs the tensor-core kernel, with 128-row query tiles and 64-key K/V
tiles: ``TILE_CASES`` straddle both tile edges, ragged S and T, S < T and
S > T under a window, B = 3, and every head width.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS
from torch_flash_tiling import BQ, WG_ROWS, band, grid, padded_dim, smem_bytes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernel has no CPU mode")
    return torch.device("cuda")


def qkv(B, S, T, H, Kv, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device).to(dtype)

    return t(B, S, H, d), t(B, T, Kv, d), t(B, T, Kv, d)


def tol(dtype, S):
    if dtype == torch.bfloat16:
        return 2e-2
    return 2e-5 if S < 256 else 1e-4


CASES = [  # B, S, T, H, Kv, d, causal, window
    (1, 32, 32, 4, 4, 32, True, None),  # MHA
    (2, 64, 64, 8, 2, 16, True, None),  # GQA 4:1
    (2, 64, 64, 4, 1, 32, True, None),  # MQA
    (1, 48, 48, 2, 2, 64, True, 16),  # SWA
    (1, 16, 64, 4, 2, 32, True, None),  # a query block shorter than the keys
    (3, 128, 128, 2, 1, 8, True, 32),
    (2, 32, 32, 4, 2, 16, False, None),  # non-causal
    (1, 80, 40, 4, 2, 16, True, None),  # S > T: the first 40 rows keep no key
    (1, 96, 96, 4, 2, 32, False, 24),  # a window without causal
    (1, 100, 100, 4, 2, 64, True, None),  # a ragged last query and key tile
    (1, 300, 300, 32, 8, 80, True, None),  # h2o-danube-1.8b's heads
    (1, 1024, 1024, 32, 8, 80, True, 256),  # danube's heads, the window bites
    (1, 1024, 1024, 8, 8, 128, True, None),  # qwen1.5-32b's head width
    (1, 200, 333, 4, 2, 128, True, 100),  # S < T under a window, d = 128
    (1, 1024, 1024, 16, 16, 128, True, None),  # moonshot-v1-16b-a3b's heads
    (1, 1500, 1500, 16, 16, 64, False, None),  # whisper-medium's encoder: T = 1500 is no multiple of 64
    (1, 448, 1500, 16, 16, 64, False, None),  # whisper's cross attention, S < T
    (1, 1024, 1024, 56, 8, 128, True, None),  # llava-next-34b's heads, 7 queries a KV head
]

TILE_CASES = [  # B, S, T, H, Kv, d, causal, window
    *[(1, n, n, 4, 2, 64, True, None) for n in (63, 64, 65, 127, 128, 129, 193)],
    *[(1, n, n, 4, 2, 80, True, 64) for n in (65, 129, 193)],
    (1, 65, 193, 4, 2, 80, True, 100),  # S < T under a window
    (1, 193, 129, 4, 2, 80, True, 50),  # S > T under a window: the first 64 rows keep no key
    (1, 129, 63, 4, 2, 32, False, 40),  # S > T, a window without causal
    (1, 63, 129, 4, 4, 128, False, None),  # non-causal, S < T
    (3, 127, 129, 8, 2, 64, True, 64),  # B = 3
    *[(2, 129, 193, 4, 2, d, True, 100) for d in HEAD_DIMS],  # every head width
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,Kv,d,causal,window", CASES + TILE_CASES)
def test_kernel_matches_plain_on_card(cuda, B, S, T, H, Kv, d, causal, window, dtype):
    q, k, v = qkv(B, S, T, H, Kv, d, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and tuple(got.shape) == (B, S, H, d)
    t = tol(dtype, S)
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)


@pytest.mark.cuda
def test_rows_with_no_key_are_the_mean_of_v(cuda):
    """S > T under causal: a row before the first key gets the reference's
    uniform softmax over the -1e30 scores, the mean of v, not zero."""
    q, k, v = qkv(1, 80, 40, 4, 2, 16, torch.float32, cuda, seed=3)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    mean_v = v.mean(dim=1).repeat_interleave(2, dim=1)  # [B, H, d]
    for row in (0, 17, 39):
        torch.testing.assert_close(got[:, row], mean_v, rtol=2e-5, atol=2e-5)
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,window", [(80, 40, None), (193, 129, 50), (129, 129, 0)])
def test_bf16_rows_with_no_key_are_the_mean_of_v(cuda, S, T, window):
    """The tensor-core kernel's empty rows: S > T under causal (the first
    S - T rows), and causal with a window of 0 (every row)."""
    q, k, v = qkv(1, S, T, 4, 2, 80, torch.bfloat16, cuda, seed=4)
    got = flash_attention.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    mean_v = v.float().mean(dim=1).repeat_interleave(2, dim=1)  # [B, H, d]
    for row in {0, S - T - 1 if S > T else S - 1}:
        torch.testing.assert_close(got[:, row].float(), mean_v, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernel_tiling_is_the_python_mirror(cuda, d):
    """The CUDA source's padded width, shared memory and key bands equal
    the Python mirror of them that the CPU tests check."""
    for S, T, causal, window in [(193, 193, True, None), (65, 300, True, 100), (300, 129, True, 50),
                                 (129, 63, False, 40), (256, 256, True, 0), (1, 1, False, None)]:
        for qt in range(grid(1, S, 1)[0]):
            plan = flash_attention.kernel_plan(d, S, T, causal, window, qt)
            assert plan["dp"] == padded_dim(d) and plan["smem"] == smem_bytes(d)
            q0 = qt * BQ
            assert plan["block"] == band(q0, min(q0 + BQ, S), S, T, causal, window)
            for w, got in enumerate(plan["warpgroups"]):
                w0 = q0 + w * WG_ROWS
                want = (0, 0, 0, 0) if w0 >= S else band(w0, min(w0 + WG_ROWS, S), S, T, causal, window)
                assert got == want, (S, T, causal, window, qt, w)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = qkv(1, 32, 32, 4, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q.cpu(), k.cpu(), v.cpu())
    q24, k24, v24 = qkv(1, 32, 32, 4, 2, 24, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_attention.flash_attention(q24, k24, v24)
    with pytest.raises(ValueError, match="contiguous"):
        vt = v.transpose(1, 2).contiguous().transpose(1, 2)
        flash_attention.flash_attention(q, k, vt)
    with pytest.raises(ValueError, match="k has dtype"):
        flash_attention.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    q3, k3, v3 = qkv(1, 32, 32, 4, 3, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of Kv"):
        flash_attention.flash_attention(q3, k3, v3)
    with pytest.raises(ValueError, match="v has shape"):
        flash_attention.flash_attention(q, k, v[:, :16].contiguous())
    with pytest.raises(ValueError, match="q on"):
        flash_attention.flash_attention(q, k, v.cpu())
    with pytest.raises(ValueError, match=r"\[B,S,H,d\]"):
        flash_attention.flash_attention(q[0], k, v)
    qb, kb, vb = qkv(1, 32, 32, 4, 2, 16, torch.bfloat16, cuda)
    shifted = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):  # contiguous, 2 bytes in
        flash_attention.flash_attention(shifted, kb, vb)


@pytest.mark.cuda
def test_launch_count_moves_once_per_kernel_launch(cuda):
    q, k, v = qkv(1, 64, 64, 4, 2, 32, torch.bfloat16, cuda)
    flash_attention.launches = 0
    for _ in range(3):
        flash_attention.flash_attention(q, k, v, window=16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q.cpu(), k.cpu(), v.cpu())
    torch.cuda.synchronize()
    assert flash_attention.launches == 3
