"""On a CUDA card: the hand-written RG-LRU kernel against its plain version.

The kernel has no CPU mode, so every case carries the ``cuda`` marker and
skips without a card.  This file imports neither JAX nor the JAX package, so
it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rglru_cuda.py

Tolerances: fp32 2e-5 (the same fp32 arithmetic, except that the h entering
each chunk is composed from the chunks before it, and the FMA rounds once
where the plain version may round twice), bf16 2e-2 (both compute in fp32
from the same bf16 inputs; the output rounds to bf16).
"""

import numpy as np
import pytest
import torch
from torch_rglru_chunks import CHUNK, MAX_CLUSTER, plan

from repro_torch.kernels import ref, rglru_scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RG-LRU kernel has no CPU mode")
    return torch.device("cuda")


def inputs(B, S, C, dtype, h0, device, seed=0, long_memory=False):
    """``long_memory`` draws Λ as the models' ``lru_a`` init does (per-step
    decay in [0.9, 0.999]); otherwise Λ ~ N(0, 1) (decay near 0.06)."""
    rng = np.random.default_rng(seed)

    def t(a, cast=None):
        out = torch.from_numpy(a.astype(np.float32)).to(device)
        return out.to(cast) if cast is not None else out

    return dict(
        x=t(rng.normal(size=(B, S, C)), dtype),
        r=t(rng.normal(size=(B, S, C)), dtype),
        i=t(rng.normal(size=(B, S, C)), dtype),
        lam=t(
            np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, size=(C,))) / 8.0))
            if long_memory
            else rng.normal(size=(C,))
        ),
        h0=None if h0 is None else t(rng.normal(size=(B, C)), h0),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,C",
    [
        (1, 1, 2560),  # a decode step at RecurrentGemma-2B's width
        (4, 1, 2560),  # a decode step over 4 slots
        (2, 8, 2560),  # the longest S the step kernel takes
        (1, 100, 2560),  # a ragged sub-chunk and piece, no cluster
        (1, CHUNK, 2560),  # one piece: the longest S without a cluster
        (1, CHUNK + 1, 2560),  # a cluster of two, the second piece one step
        (1, 1024, 2560),  # one full cluster span
        (1, MAX_CLUSTER * CHUNK + 1, 2560),  # a second round of one step
        (1, 8192, 2560),  # eight rounds: more pieces than one cluster holds
        (4, 1024, 2560),  # batch rows
        (2, 37, 100),  # ragged channels: masked scalar loads and stores
        (3, 9, 33),
    ],
)
def test_kernel_matches_plain_on_card(cuda, B, S, C, h0, dtype):
    t = inputs(B, S, C, dtype, h0, cuda)
    before = rglru_scan.launches
    y, h = rglru_scan.rglru_scan(**t)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    want_y, want_h = ref.rglru_ref(**t)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert y.dtype == dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, C) and tuple(h.shape) == (B, C)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, want_h, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [None, torch.float32])
@pytest.mark.parametrize("S", [1024, 3000])
def test_kernel_matches_plain_on_card_with_long_memory(cuda, S, h0, dtype):
    """The decays the model's init gives: h carries across the kernel's
    sub-chunks, the cluster's pieces and (at 3000) its rounds, where a dropped
    or doubled carry shows."""
    t = inputs(1, S, 2560, dtype, h0, cuda, seed=2, long_memory=True)
    y, h = rglru_scan.rglru_scan(**t)
    want_y, want_h = ref.rglru_ref(**t)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, want_h, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_inputs_not_16_byte_aligned(cuda, dtype):
    """Contiguous views that start one element into a buffer take the masked
    scalar loads and stores; the result is the same."""
    t = inputs(1, 300, 2560, dtype, torch.float32, cuda, seed=3)
    shifted = {}
    for k in ("x", "r", "i"):
        buf = torch.empty(t[k].numel() + 1, dtype=dtype, device=cuda)
        shifted[k] = buf[1:].view(t[k].shape)
        shifted[k].copy_(t[k])
    assert shifted["x"].data_ptr() % 16
    y, h = rglru_scan.rglru_scan(**{**t, **shifted})
    want_y, want_h = rglru_scan.rglru_scan(**t)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,C", [(1, 1, 2560), (4, 1, 2560), (1, 1024, 2560), (1, 3000, 2560), (1, 8192, 2560), (3, 9, 33)]
)
def test_kernel_plan_is_the_python_mirror(cuda, B, S, C, dtype):
    """The launch's tiling as the CUDA source has it, against
    tests/torch_rglru_chunks.py (checked on the CPU)."""
    assert rglru_scan.kernel_plan(dtype, B, S, C) == plan(dtype, B, S, C)


@pytest.mark.cuda
def test_kernel_continues_a_scan_through_h0(cuda):
    """Prefill then S=1 steps through the kernel equal one scan of the whole."""
    t = inputs(2, 12, 256, torch.float32, None, cuda, seed=1)
    full_y, full_h = rglru_scan.rglru_scan(**t)
    part = lambda sl: [t[k][:, sl].contiguous() for k in ("x", "r", "i")]  # noqa: E731
    y, h = rglru_scan.rglru_scan(*part(slice(0, 9)), t["lam"])
    ys = [y]
    for s in range(9, 12):
        y, h = rglru_scan.rglru_scan(*part(slice(s, s + 1)), t["lam"], h0=h)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), full_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, full_h, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = inputs(2, 16, 64, torch.float32, torch.float32, cuda)
    cpu = {k: v.cpu() for k, v in t.items()}
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan.rglru_scan(**cpu)
    with pytest.raises(ValueError, match="r has shape"):
        rglru_scan.rglru_scan(**{**t, "r": t["r"][:, :8].contiguous()})
    with pytest.raises(ValueError, match="lam has shape"):
        rglru_scan.rglru_scan(**{**t, "lam": t["lam"][:32]})
    with pytest.raises(ValueError, match="h0 has shape"):
        rglru_scan.rglru_scan(**{**t, "h0": t["h0"][:1]})
    with pytest.raises(ValueError, match="i has dtype"):
        rglru_scan.rglru_scan(**{**t, "i": t["i"].to(torch.bfloat16)})
    with pytest.raises(ValueError, match="dtype"):
        rglru_scan.rglru_scan(**{**t, "x": t["x"].half()})
    with pytest.raises(ValueError, match="x on"):
        rglru_scan.rglru_scan(**{**t, "h0": cpu["h0"]})
    with pytest.raises(ValueError, match="contiguous"):
        x = t["x"].transpose(1, 2).contiguous().transpose(1, 2)
        rglru_scan.rglru_scan(**{**t, "x": x})
    with pytest.raises(ValueError, match=r"\[B,S,C\]"):
        rglru_scan.rglru_scan(**{**t, "x": t["x"][0]})
