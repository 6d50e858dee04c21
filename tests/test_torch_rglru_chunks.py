"""PyTorch port, RG-LRU scan: the kernel's design on the CPU, through its
Python mirror ``torch_rglru_chunks.py`` (the time-chunked scan of
``csrc/rglru_scan.cu``: sub-chunks, pieces joined across a cluster, rounds,
and the second walk, with the kernel's single-rounding FMAs).

The kernel runs only on a card, where ``test_torch_rglru_cuda.py`` holds it
against the plain version and the CUDA source's plan against this mirror.
Here:
  * in fp32 the mirror computes what ``ref.rglru_ref`` and the JAX
    ``rglru_ref`` compute, within 2e-5 (the same recurrence; the carry into
    a chunk is composed in another order), at S from one step to several
    rounds of a cluster, with and without h0, with Λ ~ N(0, 1) and with the
    decays of the models' ``lru_a`` init (0.9 to 0.999 per step), where h
    carries across every chunk;
  * in bf16 within 2e-2 (the output rounds to bf16);
  * in float64 the composition is the sequential scan to 1e-12, for any
    cluster size: the algebra, apart from fp32 rounding;
  * the tiling: every (b, step, channel) is walked by exactly one thread in
    exactly one round, and one thread writes each h_last, for any S, C and
    cluster size (hypothesis); three bf16 blocks share an SM's shared memory;
  * the plain version these tests lean on: torch's CPU ``exp`` of the gates,
    on its default threads, is float64's to 1e-6.
"""

import numpy as np
import pytest
import torch
from tests.hypothesis_optional import given, settings, st
from torch_rglru_chunks import (
    CHUNK,
    MAX_CLUSTER,
    TS,
    plan,
    rglru_chunks,
    sequential,
    smem_bytes,
    static_smem_bytes,
    thread_work,
)

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro_torch.kernels import ref

FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
#: shared memory of an H100 SM, and the 1 KB the card keeps per block
SM_SMEM, BLOCK_RESERVED = 233_472, 1024


#: one step, a ragged sub-chunk, a ragged piece, one piece, one piece and a
#: step, one full cluster span, and three rounds of a cluster
LENGTHS = (1, 7, 100, CHUNK, CHUNK + 1, 1024, 3000)


def inputs(B, S, C, *, h0, long_memory, seed=0, dtype=torch.float32):
    """numpy inputs as the card tests draw them: ``long_memory`` draws Λ as
    the models' ``lru_a`` init does, otherwise Λ ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=(B, S, C)) for k in ("x", "r", "i")}
    if long_memory:
        out["lam"] = np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, size=(C,))) / 8.0))
    else:
        out["lam"] = rng.normal(size=(C,))
    if h0:
        out["h0"] = rng.normal(size=(B, C))
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}
    for k in ("x", "r", "i"):
        t[k] = t[k].to(dtype)
    return t


def f32(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("long_memory", [False, True], ids=["lam_normal", "lam_long_memory"])
@pytest.mark.parametrize("h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_scan_computes_rglru_ref_in_fp32(S, h0, long_memory):
    t = inputs(2, S, 40, h0=h0, long_memory=long_memory, seed=S)
    y, h_last = rglru_chunks(**t)
    want_y, want_h = ref.rglru_ref(**t)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, S, 40)
    torch.testing.assert_close(y, want_y, **FP32)
    torch.testing.assert_close(h_last, want_h, **FP32)
    assert torch.equal(h_last, y[:, -1])  # h_last is the walk's h at step S - 1


@pytest.mark.parametrize("long_memory", [False, True], ids=["lam_normal", "lam_long_memory"])
@pytest.mark.parametrize("h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_scan_computes_the_jax_reference_in_fp32(S, h0, long_memory):
    t = inputs(1, S, 24, h0=h0, long_memory=long_memory, seed=S + 1)
    y, h_last = rglru_chunks(**t)
    want_y, want_h = jref.rglru_ref(**{k: jnp.asarray(v.numpy()) for k, v in t.items()})
    np.testing.assert_allclose(f32(y), f32(want_y), **FP32)
    np.testing.assert_allclose(f32(h_last), f32(want_h), **FP32)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_gates_exp_is_float64_exp_on_the_default_threads(seed):
    """A witness for ``ref.rglru_gates_ref``: over a tensor as large as a
    full-width prompt's (2.6M elements, split over torch's CPU threads), the
    fp32 ``exp`` of log a and of 2 log a is float64's ``exp`` of the same
    fp32 argument within 1e-6 (relative), a few fp32 ulp."""
    t = inputs(2, 3000, 440, h0=False, long_memory=bool(seed), seed=seed + 7)
    log_a = -8.0 * torch.nn.functional.softplus(t["lam"]) * torch.sigmoid(t["r"])
    for arg in (log_a, 2.0 * log_a):
        got = torch.exp(arg).numpy().astype(np.float64)
        want = np.exp(arg.numpy().astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("S", [100, 1024, 3000])
def test_chunked_scan_meets_the_bf16_limit(S):
    t = inputs(1, S, 64, h0=True, long_memory=True, seed=S + 2, dtype=torch.bfloat16)
    y, h_last = rglru_chunks(**t)
    want_y, want_h = ref.rglru_ref(**t)
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **BF16)
    torch.testing.assert_close(h_last, want_h, **BF16)


@pytest.mark.parametrize("max_cluster", [1, 3, MAX_CLUSTER])
@pytest.mark.parametrize("S", [CHUNK + 1, 1025, 3000])
def test_composition_is_the_sequential_scan_in_float64(S, max_cluster):
    """Sub-chunks, pieces, the cluster's fold and rounds compose to the
    sequential recurrence: in float64 they agree to 1e-12 for any cluster."""
    t = inputs(2, S, 16, h0=True, long_memory=True, seed=S)
    a, b = (v.double() for v in ref.rglru_gates_ref(**{k: v for k, v in t.items() if k != "h0"}))
    h0 = t["h0"].double()
    y, h_last = rglru_chunks(**t, max_cluster=max_cluster, gates=(a, b))
    want = sequential(a, b, h0)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(h_last, want[:, -1], rtol=1e-12, atol=1e-12)


def test_decode_takes_the_step_kernel_and_short_prompts_one_piece():
    """S <= TS (a decode step) takes the step kernel, one thread a channel;
    up to CHUNK the chunked kernel launches without a cluster; past it, with
    one."""
    for S in (1, TS):
        p = plan(torch.bfloat16, 4, S, 2560)
        assert (p["step"], p["grid_x"], p["grid_y"], p["threads"], p["smem"]) == (1, 20, 4, 128, 0)
    for S in (TS + 1, CHUNK):
        p = plan(torch.bfloat16, 4, S, 2560)
        assert (p["step"], p["cluster"], p["rounds"], p["grid_x"], p["grid_y"]) == (0, 1, 1, 40, 4)
    assert plan(torch.bfloat16, 1, CHUNK + 1, 2560)["cluster"] == 2


@pytest.mark.parametrize(
    "dtype,B,S,C,want",
    [  # want: cluster, rounds, grid_x, grid_y
        (torch.bfloat16, 1, 1024, 2560, (8, 1, 320, 1)),  # a 1024-token RecurrentGemma-2B prefill
        (torch.bfloat16, 1, 3000, 2560, (8, 3, 320, 1)),  # three rounds of the cluster
        (torch.bfloat16, 1, 8192, 2560, (8, 8, 320, 1)),
        (torch.bfloat16, 4, 1, 2560, (1, 1, 20, 4)),  # a decode step over 4 slots: the step kernel
        (torch.float32, 1, 1024, 2560, (8, 1, 640, 1)),  # fp32: 32-channel tiles
        (torch.float32, 2, 37, 100, (1, 1, 4, 2)),
        (torch.bfloat16, 3, 9, 33, (1, 1, 1, 3)),
    ],
)
def test_plan_at_the_serving_shapes(dtype, B, S, C, want):
    p = plan(dtype, B, S, C)
    assert (p["cluster"], p["rounds"], p["grid_x"], p["grid_y"]) == want
    assert p["rounds"] * p["cluster"] * CHUNK >= S > (p["rounds"] * p["cluster"] - 1) * CHUNK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_blocks_share_an_sm(dtype):
    """Shared memory allows three resident blocks per SM (320 blocks of a
    1024-token bf16 prefill then fit on 132 SMs at once)."""
    per_block = smem_bytes(dtype) + static_smem_bytes(dtype) + BLOCK_RESERVED
    assert 3 * per_block <= SM_SMEM
    assert smem_bytes(torch.bfloat16) == 65_536 and static_smem_bytes(torch.bfloat16) == 9_728


@settings(max_examples=50, deadline=None)
@given(
    B=st.integers(1, 2),
    S=st.one_of(st.integers(1, TS), st.integers(1, 1100)),
    C=st.integers(1, 150),
    bf16=st.booleans(),
    max_cluster=st.integers(1, MAX_CLUSTER),
)
def test_every_step_and_channel_is_walked_exactly_once(B, S, C, bf16, max_cluster):
    dtype = torch.bfloat16 if bf16 else torch.float32
    p = plan(dtype, B, S, C, max_cluster)
    walked = np.zeros((B, S, C), np.int32)
    last = np.zeros((B, C), np.int32)
    for by in range(p["grid_y"]):
        for bx in range(p["grid_x"]):
            for tid in range(p["threads"]):
                for rd in range(p["rounds"]):
                    steps, chans = thread_work(p, S, C, bx, tid, rd)
                    if len(steps) and len(chans):
                        walked[by, steps.start:steps.stop, chans.start:chans.stop] += 1
                        if steps.stop == S:
                            last[by, chans.start:chans.stop] += 1
    assert (walked == 1).all()
    assert (last == 1).all()
