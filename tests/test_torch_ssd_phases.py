"""PyTorch port, SSD scan: the bf16 kernel's design on the CPU, through its
Python mirror ``torch_ssd_phases.py`` (the three passes of
``csrc/ssd_scan.cu`` and their tiling).

The kernel runs only on a card, where ``test_torch_ssd_cuda.py`` holds it
against the plain version and the CUDA source's tiling values against this
mirror.  Here:
  * in fp32 the passes compute what ``ref.ssd_ref`` and the JAX ``ssd_ref``
    compute (2e-5: the same sums in another order), ragged chunks, groups,
    ``state0`` and a decay steep enough that cum falls below -88 inside a
    chunk included.  At S=4096 (16 chunks) the JAX ``ssd_ref`` is itself up
    to ~3e-5 from the float64 evaluation at a few elements (its fp32 cumsum
    adds in another order), so there the passes are held to it within that
    gap plus 2e-5, element by element, and the gap under 1e-4;
  * with the kernel's rounding points (every fp32 operand of a tensor-core
    product as a bf16 high and low part) they meet the element-wise bf16
    limit of the card checks (2e-2) at Mamba2-1.3B's widths over five seeds,
    where one bf16 copy of each operand would not;
  * the tiling: shared memory for two blocks per SM, the grids, and the
    tiles each 64-row output tile visits against a brute-force causal mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.hypothesis_optional import given, settings, st
from torch_ssd_phases import (
    MAX_CHUNK,
    TILE,
    TWO_BLOCKS_SMEM,
    chunk_pass,
    grids,
    output_tiles,
    smem_bytes,
    ssd_phases,
    stored_rows,
    tiles,
)

import torch_ssd_phases
from repro.kernels import ref as jref
from repro_torch.kernels import ref

FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
#: Mamba2-1.3B's SSD widths
H_FULL, P, N = 64, 64, 128


def inputs(S, H, G, *, state0, seed=0, dt_range=(1e-3, 0.1), bf16=False):
    """numpy inputs as the card tests draw them; ``dt_range`` (0.5, 2) is
    the steep decay."""
    rng = np.random.default_rng(seed)
    out = dict(
        x=rng.normal(size=(1, S, H, P)),
        dt=rng.uniform(*dt_range, size=(1, S, H)),
        A_log=rng.uniform(0, 2, size=(H,)),
        Bm=rng.normal(size=(1, S, G, N)),
        Cm=rng.normal(size=(1, S, G, N)),
        D=rng.normal(size=(H,)),
    )
    if state0:
        out["state0"] = rng.normal(size=(1, H, P, N))
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}
    if bf16:
        for k in ("x", "Bm", "Cm"):
            t[k] = t[k].to(torch.bfloat16)
    return t


@pytest.mark.parametrize("state0", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [100, 256, 1024, 4096])
def test_passes_compute_ssd_ref_in_fp32(S, G, state0):
    t = inputs(S, 4, G, state0=state0, seed=S + G)
    chunk = min(MAX_CHUNK, S)
    y, final = ssd_phases(**t, chunk=chunk)
    want_y, want_final = ref.ssd_ref(**t, chunk=chunk)
    torch.testing.assert_close(y, want_y, **FP32)
    torch.testing.assert_close(final, want_final, **FP32)
    y64, final64 = ssd_phases(**{k: v.double() for k, v in t.items()}, chunk=chunk)
    torch.testing.assert_close(y.double(), y64, **FP32)
    torch.testing.assert_close(final.double(), final64, **FP32)


@pytest.mark.parametrize("state0", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [100, 256, 1024])
def test_passes_compute_the_jax_reference_in_fp32(S, G, state0):
    t = inputs(S, 4, G, state0=state0, seed=S + G)
    chunk = min(MAX_CHUNK, S)
    y, final = ssd_phases(**t, chunk=chunk)
    jy, jfinal = jref.ssd_ref(**{k: jnp.asarray(v.numpy()) for k, v in t.items()}, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **FP32)


@pytest.mark.parametrize("state0", [False, True])
@pytest.mark.parametrize("G", [1, 2])
def test_passes_compute_the_jax_reference_at_sixteen_chunks(G, state0):
    t = inputs(4096, 4, G, state0=state0, seed=4096 + G)
    got = ssd_phases(**t, chunk=256)
    exact = ssd_phases(**{k: v.double() for k, v in t.items()}, chunk=256)
    jax_out = jref.ssd_ref(**{k: jnp.asarray(v.numpy()) for k, v in t.items()}, chunk=256)
    for mine, theirs, ex in zip(got, jax_out, exact):
        theirs = torch.from_numpy(np.asarray(theirs)).double()
        gap = (theirs - ex).abs()
        assert gap.max() < 1e-4
        limit = gap + FP32["atol"] + FP32["rtol"] * theirs.abs()
        assert ((mine.double() - theirs).abs() <= limit).all()


@pytest.mark.parametrize("S,chunk", [(512, 256), (100, 100)])
def test_passes_under_a_steep_decay(S, chunk):
    """dt in (0.5, 2): cum falls below -88 inside the first 64-row tile, so
    exp(cum_i) exp(-cum_j) would overflow fp32; the passes take exp(cum_i -
    cum_j) per element, and exp(cum_i) only on the entering state."""
    t = inputs(S, H_FULL, 1, state0=True, dt_range=(0.5, 2.0))
    cum, _ = chunk_pass(t["x"], t["dt"], t["A_log"], t["Bm"], chunk, split=False)
    assert cum[:, :, :TILE].min() < -88
    y, final = ssd_phases(**t, chunk=chunk)
    want_y, want_final = ref.ssd_ref(**t, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    torch.testing.assert_close(y, want_y, **FP32)
    torch.testing.assert_close(final, want_final, **FP32)


@pytest.mark.parametrize("state0", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_split_operands_meet_the_bf16_limit_at_full_width(seed, state0):
    """S=1024, H=64, chunk 256: the kernel's rounding points against the
    plain version on the same bf16 inputs, y and the final state."""
    t = inputs(1024, H_FULL, 1, state0=state0, seed=seed, bf16=True)
    y, final = ssd_phases(**t, chunk=256, split=True)
    want_y, want_final = ref.ssd_ref(**t, chunk=256)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want_y.float(), **BF16)
    torch.testing.assert_close(final, want_final, **BF16)


def test_one_bf16_copy_of_each_operand_misses_the_bf16_limit(monkeypatch):
    """Why the kernel splits: with a single bf16 copy of x*w, the entering
    state and W, y leaves the limit at some elements (with state0 most)."""
    t = inputs(1024, H_FULL, 1, state0=True, seed=0, bf16=True)
    monkeypatch.setattr(torch_ssd_phases, "_split", lambda a: a.to(torch.bfloat16).float())
    y, _ = ssd_phases(**t, chunk=256, split=True)
    want_y, _ = ref.ssd_ref(**t, chunk=256)
    assert not torch.isclose(y.float(), want_y.float(), **BF16).all()


def test_shared_memory_leaves_room_for_two_blocks_per_sm():
    for name, nbytes in smem_bytes().items():
        assert nbytes <= TWO_BLOCKS_SMEM, f"{name} pass: {nbytes} bytes"
    assert TWO_BLOCKS_SMEM == 115_712


def test_grids_of_a_1024_token_mamba2_layer():
    assert grids(1, 1024, H_FULL, 256) == {
        "chunk": ((4, 64, 1), 128),
        "state": ((32, 64, 1), 256),
        "output": ((16, 64, 1), 128),
    }
    assert grids(3, 100, 8, 100)["output"] == ((2, 8, 3), 128)


def check_tiles(L):
    """Output tile t stores rows [64t, min(64t + 64, L)) and multiplies in
    the 64-row source tiles it visits; against the causal mask j <= i < L."""
    mask = np.tril(np.ones((L, L), bool))
    covered = np.zeros((L, L), bool)
    stored = []
    for t in range(tiles(L)):
        rows = stored_rows(L, t)
        assert len(rows) > 0
        stored.extend(rows)
        for j0 in output_tiles(L, t):
            block = mask[rows.start:rows.stop, j0:j0 + TILE]
            assert block.any(), f"tile {t} visits source tile {j0} with no kept pair"
            covered[rows.start:rows.stop, j0:j0 + TILE] = True
    assert stored == list(range(L)), "every row of the chunk is stored once"
    assert not (mask & ~covered).any(), f"a kept pair lies outside the visited tiles at L={L}"


@pytest.mark.parametrize("L", [1, 63, 64, 65, 100, 128, 129, 255, 256])
def test_visited_tiles_cover_the_causal_triangle(L):
    check_tiles(L)


@settings(max_examples=100, deadline=None)
@given(L=st.integers(min_value=1, max_value=MAX_CHUNK), B=st.integers(1, 4), H=st.integers(1, 96),
       nc=st.integers(1, 20))
def test_tile_plan_against_a_brute_force_mask(L, B, H, nc):
    check_tiles(L)
    g = grids(B, nc * L, H, L)
    assert g["chunk"] == ((nc, H, B), 128)
    assert g["output"] == ((nc * tiles(L), H, B), 128)
    assert g["state"][0][0] * g["state"][1] == P * N
