"""On a CUDA card: the hand-written SSD kernel against its plain version.

The kernel has no CPU mode, so every case carries the ``cuda`` marker and
skips without a card.  This file imports neither JAX nor the JAX package, so
it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

Tolerances: fp32 1e-4 (fp32 sums in another order), bf16 2e-2 (the plain
version computes in fp32 from the same bf16 inputs; the kernel's tensor-core
products take each fp32 operand as a bf16 high and low part, and the output
rounds to bf16).
"""

import numpy as np
import pytest
import torch
from torch_ssd_phases import grids, smem_bytes

from repro_torch.kernels import ref, ssd_scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernel has no CPU mode")
    return torch.device("cuda")


def inputs(B, S, H, G, dtype, state0, device, seed=0, dt_range=(1e-3, 0.1)):
    """``dt_range`` (0.5, 2) is the steep decay: cum falls below -88 within
    a few dozen rows, where exp(cum_i) exp(-cum_j) would overflow fp32."""
    rng = np.random.default_rng(seed)
    P, N = ssd_scan.HEAD_DIM, ssd_scan.D_STATE

    def t(a, cast=False):
        out = torch.from_numpy(a.astype(np.float32)).to(device)
        return out.to(dtype) if cast else out

    return dict(
        x=t(rng.normal(size=(B, S, H, P)), True),
        dt=t(rng.uniform(*dt_range, size=(B, S, H))),
        A_log=t(rng.uniform(0, 2, size=(H,))),
        Bm=t(rng.normal(size=(B, S, G, N)), True),
        Cm=t(rng.normal(size=(B, S, G, N)), True),
        D=t(rng.normal(size=(H,))),
        state0=t(rng.normal(size=(B, H, P, N))) if state0 else None,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,G,chunk,state0,dt_range",
    [
        (1, 256, 64, 1, 256, False, (1e-3, 0.1)),  # one full chunk, Mamba2-1.3B widths
        (1, 1024, 64, 1, 256, True, (1e-3, 0.1)),  # four chunks: state carried across them
        (1, 100, 64, 1, 100, False, (1e-3, 0.1)),  # ragged chunk (a 100-token prompt)
        (2, 200, 4, 2, 40, True, (1e-3, 0.1)),  # batch, groups, several short chunks
        (1, 4096, 64, 1, 256, True, (1e-3, 0.1)),  # sixteen chunks (a 4096-token prompt)
        (3, 512, 8, 2, 256, True, (1e-3, 0.1)),  # three batch rows, two groups
        (1, 512, 64, 1, 256, True, (0.5, 2.0)),  # steep decay: cum far below -88
        (1, 100, 64, 1, 100, True, (0.5, 2.0)),  # ragged chunk under the steep decay
    ],
)
def test_kernel_matches_plain_on_card(cuda, B, S, H, G, chunk, state0, dt_range, dtype):
    t = inputs(B, S, H, G, dtype, state0, cuda, dt_range=dt_range)
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
@pytest.mark.parametrize("B,S,H,chunk", [(1, 1024, 64, 256), (1, 100, 64, 100), (3, 200, 4, 40)])
def test_kernel_tiling_is_the_python_mirror(cuda, B, S, H, chunk):
    """The bf16 passes' shared memory, grids and threads as the CUDA source
    has them, against tests/torch_ssd_phases.py (checked on the CPU)."""
    plan = ssd_scan.kernel_plan(B, S, H, chunk)
    assert plan["smem"] == smem_bytes()
    assert plan["grids"] == grids(B, S, H, chunk)


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
    tb = inputs(1, 64, 64, 1, torch.bfloat16, False, cuda)
    x = torch.empty(tb["x"].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(tb["x"].shape)
    with pytest.raises(ValueError, match="aligned"):  # the bf16 passes copy 16 bytes at a time
        ssd_scan.ssd_scan(**{**tb, "x": x}, chunk=64)
