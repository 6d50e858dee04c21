"""PyTorch port, flash attention: the bf16 tensor-core kernel's tiling,
as ``torch_flash_tiling.py`` mirrors it from ``csrc/flash_attention.cu``, on
the CPU.

The kernel itself runs only on a card, where ``test_torch_flash_cuda.py``
holds the CUDA source's own values (``flash_attention_plan``) to this
mirror.  Here: the padded head width and the shared memory of each
instantiated width, the grid, and the band of KV tiles a 128-row query tile
(and each of its two 64-row warpgroups) visits, held against a brute-force
mask: every kept (query, key) pair lies in a visited tile, every visited
tile holds a kept pair, and a tile the kernel leaves unmasked is kept whole
by every row.  No JAX.
"""

import numpy as np
import pytest
from tests.hypothesis_optional import given, settings, st
from torch_flash_tiling import BK, BQ, SMEM_LIMIT, WG_ROWS, band, grid, padded_dim, smem_bytes

from repro_torch.kernels.flash_attention import HEAD_DIMS

#: shared memory of one SM that blocks may share (H100: 228 KB), and what
#: the card reserves for each block
SM_SMEM, BLOCK_RESERVED = 233_472, 1024


def kept(S, T, causal, window):
    """The reference's mask: [S, T], query i at position i + T - S."""
    qpos = np.arange(S)[:, None] + (T - S)
    kpos = np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def visited(lo, hi):
    """Key tiles the kernel visits for a band: from lo's tile while below hi."""
    return list(range(lo // BK * BK, hi, BK)) if hi > lo else []


def check_rows(mask, r0, r1, T, causal, window):
    """The band of rows [r0, r1) against the mask's rows."""
    S = mask.shape[0]
    lo, hi, all_lo, all_hi = band(r0, r1, S, T, causal, window)
    rows = mask[r0:r1]
    tiles = visited(lo, hi)
    covered = np.zeros(T, bool)
    for k0 in tiles:
        covered[k0:k0 + BK] = True
        assert rows[:, k0:k0 + BK].any(), f"tile {k0} of rows [{r0}, {r1}) holds no kept pair"
        if k0 >= all_lo and k0 + BK <= all_hi:
            assert rows[:, k0:k0 + BK].all(), f"unmasked tile {k0} of rows [{r0}, {r1}) drops a key"
    assert not (rows & ~covered[None, :]).any(), f"rows [{r0}, {r1}) keep a key outside {tiles}"
    assert (hi > lo) == bool(rows.any())
    return set(tiles)


def check_plan(S, T, causal, window):
    mask = kept(S, T, causal, window)
    n_tiles = grid(1, S, 1)[0]
    for qt in range(n_tiles):
        q0 = qt * BQ
        block = check_rows(mask, q0, min(q0 + BQ, S), T, causal, window)
        for w0 in range(q0, min(q0 + BQ, S), WG_ROWS):
            assert check_rows(mask, w0, min(w0 + WG_ROWS, S), T, causal, window) <= block


@pytest.mark.parametrize("d,dp", [(8, 64), (16, 64), (32, 64), (64, 64), (80, 128), (128, 128)])
def test_padded_width_is_the_swizzle_atom_multiple(d, dp):
    assert d in HEAD_DIMS
    assert padded_dim(d) == dp


def test_every_head_width_is_covered():
    assert HEAD_DIMS == (8, 16, 32, 64, 80, 128)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_shared_memory_fits_two_blocks_per_sm(d):
    smem = smem_bytes(d)
    assert smem == (128 + 4 * 64) * padded_dim(d) * 2 + 1024
    assert smem <= SMEM_LIMIT
    assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM


def test_shared_memory_at_the_widest_tiles_is_96_kb_plus_alignment():
    assert smem_bytes(80) == smem_bytes(128) == 96 * 1024 + 1024


@pytest.mark.parametrize("B,S,H", [(1, 1, 1), (1, 127, 32), (1, 128, 32), (1, 129, 32), (3, 4096, 32), (2, 5000, 8)])
def test_grid_covers_every_query_row_once(B, S, H):
    gx, gy, gz = grid(B, S, H)
    assert (gy, gz) == (H, B)
    assert (gx - 1) * BQ < S <= gx * BQ


EDGES = (1, 63, 64, 65, 127, 128, 129, 193)


@pytest.mark.parametrize("S", EDGES)
@pytest.mark.parametrize("T", EDGES)
def test_causal_band_at_tile_edges(S, T):
    check_plan(S, T, True, None)


@pytest.mark.parametrize(
    "S,T,causal,window",
    [
        (4096, 4096, True, 4096),  # h2o-danube-1.8b's 4096-token prefill
        (5000, 5000, True, 4096),  # longer than the window
        (193, 129, True, 50),  # S > T under a window
        (65, 193, True, 100),  # S < T under a window
        (129, 63, False, 40),  # a window without causal
        (129, 129, False, 0),  # non-causal, window 0: keys after the query
        (129, 129, True, 0),  # causal, window 0: no key at all
        (100, 100, True, -3),
        (300, 300, False, None),
    ],
)
def test_band_at_named_shapes(S, T, causal, window):
    check_plan(S, T, causal, window)


def test_causal_window_of_zero_visits_nothing():
    assert visited(*band(0, 128, 129, 129, True, 0)[:2]) == []


def test_danube_prefill_visits_the_predicted_tiles():
    """At S = T = 4096, window 4096, warpgroup i visits tiles 0..i: 2,080
    tiles of 64 x 64 per head, the count PERF.md's prediction uses."""
    S = 4096
    total = sum(
        len(visited(*band(w0, w0 + WG_ROWS, S, S, True, 4096)[:2])) for w0 in range(0, S, WG_ROWS)
    )
    assert total == 2080


@settings(max_examples=150, deadline=None)
@given(
    S=st.integers(min_value=1, max_value=400),
    T=st.integers(min_value=1, max_value=400),
    causal=st.booleans(),
    window=st.one_of(st.none(), st.integers(min_value=-10, max_value=450)),
)
def test_band_against_brute_force_mask(S, T, causal, window):
    check_plan(S, T, causal, window)
