"""On a CUDA card: the hand-written SSD kernel against its plain version.

The kernel has no CPU mode, so every case carries the ``cuda`` marker and
skips without a card.  This file imports neither JAX nor the JAX package, so
it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

Tolerances: fp32 1e-4 (fp32 sums in another order), bf16 2e-2 (both compute
in fp32 from the same bf16 inputs; the output rounds to bf16).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, ssd_scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernel has no CPU mode")
    return torch.device("cuda")


def inputs(B, S, H, G, dtype, state0, device, seed=0):
    rng = np.random.default_rng(seed)
    P, N = ssd_scan.HEAD_DIM, ssd_scan.D_STATE

    def t(a, cast=False):
        out = torch.from_numpy(a.astype(np.float32)).to(device)
        return out.to(dtype) if cast else out

    return dict(
        x=t(rng.normal(size=(B, S, H, P)), True),
        dt=t(rng.uniform(1e-3, 0.1, size=(B, S, H))),
        A_log=t(rng.uniform(0, 2, size=(H,))),
        Bm=t(rng.normal(size=(B, S, G, N)), True),
        Cm=t(rng.normal(size=(B, S, G, N)), True),
        D=t(rng.normal(size=(H,))),
        state0=t(rng.normal(size=(B, H, P, N))) if state0 else None,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,G,chunk,state0",
    [
        (1, 256, 64, 1, 256, False),  # one full chunk, Mamba2-1.3B widths
        (1, 1024, 64, 1, 256, True),  # four chunks: state carried across them
        (1, 100, 64, 1, 100, False),  # ragged chunk (a 100-token prompt)
        (2, 200, 4, 2, 40, True),  # batch, groups, several short chunks
    ],
)
def test_kernel_matches_plain_on_card(cuda, B, S, H, G, chunk, state0, dtype):
    t = inputs(B, S, H, G, dtype, state0, cuda)
    before = ssd_scan.launches
    y, st = ssd_scan.ssd_scan(**t, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_st = ref.ssd_ref(**t, chunk=chunk)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, want_st, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = inputs(1, 64, 64, 1, torch.float32, False, cuda)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_scan(**t, chunk=48)  # does not divide S
    with pytest.raises(ValueError, match="dt"):
        ssd_scan.ssd_scan(**{**t, "dt": t["dt"].to(torch.bfloat16)}, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        x = t["x"].transpose(1, 2).contiguous().transpose(1, 2)
        ssd_scan.ssd_scan(**{**t, "x": x}, chunk=64)
