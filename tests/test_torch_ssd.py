"""PyTorch port, SSD scan: the port's plain version against the JAX reference
and the Pallas kernel (interpret mode), the scan identities on the port's own
functions, and the CPU dispatch of ``ops.ssd`` (the hand-written kernel
against its plain version is ``test_torch_ssd_cuda.py``, on a card).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: fp32 2e-5 (same algorithm, different summation order), bf16
2e-2 (both compute in fp32 from the same bf16 inputs and round the output).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_devices import elsewhere

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_pallas
from repro_torch.kernels import ops, ref, ssd_scan

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def ssd_np(B, S, H, P, G, N, dtype="float32", seed=0, state0=False):
    rng = np.random.default_rng(seed)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16" else (lambda a: a)
    out = dict(
        x=cast(rng.normal(size=(B, S, H, P)).astype(np.float32)),
        dt=rng.uniform(1e-3, 0.1, size=(B, S, H)).astype(np.float32),
        A_log=rng.uniform(0, 2, size=(H,)).astype(np.float32),
        Bm=cast(rng.normal(size=(B, S, G, N)).astype(np.float32)),
        Cm=cast(rng.normal(size=(B, S, G, N)).astype(np.float32)),
        D=rng.normal(size=(H,)).astype(np.float32),
    )
    if state0:
        out["state0"] = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return out


def to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().cpu().numpy()
    return np.asarray(t, np.float32)


def torch_args(d, device="cpu"):
    return {k: to_torch(v, device) for k, v in d.items()}


SWEEP = [(1, 32, 2, 16, 1, 8, 8), (2, 64, 4, 16, 2, 8, 16), (1, 128, 8, 32, 2, 16, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SWEEP)
def test_ssd_ref_matches_jax_ref_and_pallas(B, S, H, P, G, N, chunk, dtype):
    d = ssd_np(B, S, H, P, G, N, dtype)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    want_y, want_st = jref.ssd_ref(**jd, chunk=chunk)
    pal_y, pal_st = ssd_pallas(**jd, chunk=chunk, interpret=True)
    got_y, got_st = ref.ssd_ref(**torch_args(d), chunk=chunk)
    assert got_y.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert got_st.dtype == torch.float32
    np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL[dtype])
    np.testing.assert_allclose(f32(got_y), f32(pal_y), **TOL[dtype])
    np.testing.assert_allclose(f32(got_st), f32(want_st), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(f32(got_st), f32(pal_st), rtol=1e-3, atol=1e-3)


def test_ssd_ref_state0_matches_jax_ref():
    d = ssd_np(2, 48, 4, 16, 2, 8, state0=True)
    want_y, want_st = jref.ssd_ref(**{k: jnp.asarray(v) for k, v in d.items()}, chunk=16)
    got_y, got_st = ref.ssd_ref(**torch_args(d), chunk=16)
    np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL["float32"])
    np.testing.assert_allclose(f32(got_st), f32(want_st), rtol=2e-5, atol=2e-5)


def test_ssd_chunked_equals_sequential():
    """The chunked scan equals the token-by-token recurrence (the decode
    path) — the state-space duality identity, on the port's functions."""
    B, S, H, P, G, N = 2, 24, 2, 8, 1, 4
    t = torch_args(ssd_np(B, S, H, P, G, N))
    want_y, want_st = ref.ssd_ref(**t, chunk=8)
    st = torch.zeros(B, H, P, N)
    for i in range(S):
        y_t, st = ref.ssd_step_ref(
            st, t["x"][:, i], t["dt"][:, i], t["A_log"], t["Bm"][:, i], t["Cm"][:, i], t["D"]
        )
        np.testing.assert_allclose(f32(y_t), f32(want_y[:, i]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(st), f32(want_st), rtol=2e-4, atol=2e-4)


def test_ssd_state_continuation():
    """Splitting a sequence and carrying the state through state0 is exact."""
    t = torch_args(ssd_np(1, 32, 2, 8, 1, 4))
    full, st_full = ref.ssd_ref(**t, chunk=8)

    def part(sl, state0=None):
        return ref.ssd_ref(
            t["x"][:, sl], t["dt"][:, sl], t["A_log"], t["Bm"][:, sl], t["Cm"][:, sl],
            t["D"], chunk=8, state0=state0,
        )

    ya, sa = part(slice(0, 16))
    yb, sb = part(slice(16, 32), sa)
    np.testing.assert_allclose(f32(torch.cat([ya, yb], 1)), f32(full), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(sb), f32(st_full), rtol=2e-4, atol=2e-4)


def test_ops_ssd_on_cpu_runs_the_plain_version():
    t = torch_args(ssd_np(1, 64, 64, 64, 1, 128))
    before = ssd_scan.launches
    y, st = ops.ssd(**t, chunk=32)
    assert ssd_scan.launches == before  # no kernel launch on the CPU
    want_y, want_st = ref.ssd_ref(**t, chunk=32)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the kernel's wrapper: only ops.ssd picks the plain
    version, and only for a CPU tensor."""
    t = torch_args(ssd_np(1, 64, 64, 64, 1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_scan(**t, chunk=64)


def test_ops_ssd_refuses_other_devices():
    """A meta tensor takes the shape function (the dry run's route); a
    device with no kernel, plain version or shape function raises."""
    t = {k: elsewhere(v) for k, v in torch_args(ssd_np(1, 8, 64, 64, 1, 128)).items()}
    with pytest.raises(ValueError, match="device"):
        ops.ssd(**t, chunk=8)
