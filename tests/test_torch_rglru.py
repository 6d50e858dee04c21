"""PyTorch port, RG-LRU: the port's plain version against the JAX reference
and the Pallas kernel (interpret mode), the step recurrence continuing the
scan, and the CPU dispatch of ``ops.rglru`` (the hand-written kernel against
its plain version is ``test_torch_rglru_cuda.py``, on a card).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: fp32 2e-5 (same arithmetic, another order of operations), bf16
2e-2 (both compute in fp32 from the same bf16 inputs and round the output).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_devices import elsewhere

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro_torch.kernels import ops, ref, rglru_scan

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def rglru_np(B, S, C, dtype="float32", seed=0, h0=False, scale=1.0):
    rng = np.random.default_rng(seed)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16" else (lambda a: a)
    out = {
        k: cast((rng.normal(size=(B, S, C)) * scale).astype(np.float32)) for k in ("x", "r", "i")
    }
    out["lam"] = rng.normal(size=(C,)).astype(np.float32)
    if h0:
        out["h0"] = rng.normal(size=(B, C)).astype(np.float32)
    return out


def long_memory_lam(C, seed=0) -> np.ndarray:
    """Λ drawn as the models' ``lru_a`` init draws it: a per-step decay
    exp(-8·softplus(Λ)) = u in [0.9, 0.999], the regime where h carries far."""
    u = np.random.default_rng(seed).uniform(0.9, 0.999, size=(C,))
    return np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def both(d):
    return {k: jnp.asarray(v) for k, v in d.items()}, {k: to_torch(v) for k, v in d.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,C,blk", [(1, 16, 32, 32), (2, 64, 128, 64), (3, 33, 96, 32)])
def test_rglru_ref_matches_jax_ref_and_pallas(B, S, C, blk, dtype):
    jd, td = both(rglru_np(B, S, C, dtype))
    want_y, want_h = jref.rglru_ref(**jd)
    pal_y, pal_h = rglru_pallas(**jd, blk_c=blk, interpret=True)
    got_y, got_h = ref.rglru_ref(**td)
    assert got_y.dtype == td["x"].dtype and got_h.dtype == torch.float32
    assert tuple(got_y.shape) == (B, S, C) and tuple(got_h.shape) == (B, C)
    for want in (want_y, pal_y):
        np.testing.assert_allclose(f32(got_y), f32(want), **TOL[dtype])
    for want in (want_h, pal_h):
        np.testing.assert_allclose(f32(got_h), f32(want), **TOL[dtype])


def test_rglru_ref_with_initial_state_matches_jax():
    jd, td = both(rglru_np(2, 8, 16, h0=True, seed=1))
    want_y, want_h = jref.rglru_ref(**jd)
    pal_y, pal_h = rglru_pallas(**jd, interpret=True)
    got_y, got_h = ref.rglru_ref(**td)
    for want_y_, want_h_ in ((want_y, want_h), (pal_y, pal_h)):
        np.testing.assert_allclose(f32(got_y), f32(want_y_), **TOL["float32"])
        np.testing.assert_allclose(f32(got_h), f32(want_h_), **TOL["float32"])


def test_rglru_gates_and_step_match_jax():
    jd, td = both(rglru_np(2, 1, 16, h0=True, seed=2))
    ja, jb = jref.rglru_gates_ref(jd["x"], jd["r"], jd["i"], jd["lam"])
    ta, tb = ref.rglru_gates_ref(td["x"], td["r"], td["i"], td["lam"])
    np.testing.assert_allclose(f32(ta), f32(ja), **TOL["float32"])
    np.testing.assert_allclose(f32(tb), f32(jb), **TOL["float32"])
    jy, jh = jref.rglru_step_ref(jd["h0"], jd["x"][:, 0], jd["r"][:, 0], jd["i"][:, 0], jd["lam"])
    ty, th = ops.rglru_step(td["h0"], td["x"][:, 0], td["r"][:, 0], td["i"][:, 0], td["lam"])
    np.testing.assert_allclose(f32(ty), f32(jy), **TOL["float32"])
    np.testing.assert_allclose(f32(th), f32(jh), **TOL["float32"])


def test_rglru_step_continues_the_scan():
    """The decode recurrence continues the prefill scan: step by step from
    zeros gives the scan's outputs and final state."""
    t = {k: to_torch(v) for k, v in rglru_np(2, 9, 16, seed=3).items()}
    want_y, want_h = ref.rglru_ref(**t)
    h = torch.zeros(2, 16)
    for s in range(9):
        y_t, h = ref.rglru_step_ref(h, t["x"][:, s], t["r"][:, s], t["i"][:, s], t["lam"])
        np.testing.assert_allclose(f32(y_t), f32(want_y[:, s]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(h), f32(want_h), rtol=1e-4, atol=1e-4)


def test_rglru_scan_continues_through_h0():
    """Splitting a sequence and carrying h_last in as h0 gives the whole scan
    (the kernel's S=1 decode call relies on it)."""
    t = {k: to_torch(v) for k, v in rglru_np(2, 20, 16, seed=4).items()}
    full_y, full_h = ref.rglru_ref(**t)
    part = lambda sl, h0=None: ref.rglru_ref(  # noqa: E731
        t["x"][:, sl], t["r"][:, sl], t["i"][:, sl], t["lam"], h0=h0
    )
    ya, ha = part(slice(0, 13))
    yb, hb = part(slice(13, 20), ha)
    np.testing.assert_allclose(f32(torch.cat([ya, yb], 1)), f32(full_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(hb), f32(full_h), rtol=1e-5, atol=1e-5)


def test_rglru_ref_stays_finite_on_a_long_prompt():
    """A long prompt with strong decay: a log-space cumsum would overflow
    here; the sequential scan agrees with the JAX associative scan."""
    d = rglru_np(1, 3000, 8, seed=5, scale=3.0)
    d["lam"] = np.full((8,), 4.0, np.float32)  # a = exp(-8·softplus(4)·σ(r)) ≪ 1
    jd, td = both(d)
    want_y, want_h = jref.rglru_ref(**jd)
    got_y, got_h = ref.rglru_ref(**td)
    assert bool(torch.isfinite(got_y).all())
    np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL["float32"])
    np.testing.assert_allclose(f32(got_h), f32(want_h), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1024, 3000])
def test_rglru_ref_matches_jax_with_long_memory(S, dtype):
    """Decays of 0.9 to 0.999 as the model's init gives them: h carries
    across hundreds of steps, where a dropped carry or a drifting sum shows."""
    d = rglru_np(1, S, 32, dtype, seed=6, h0=True)
    d["lam"] = long_memory_lam(32, seed=6)
    jd, td = both(d)
    want_y, want_h = jref.rglru_ref(**jd)
    got_y, got_h = ref.rglru_ref(**td)
    np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL[dtype])
    np.testing.assert_allclose(f32(got_h), f32(want_h), **TOL[dtype])


def test_ops_rglru_on_cpu_runs_the_plain_version():
    t = {k: to_torch(v) for k, v in rglru_np(2, 12, 32, "bfloat16", h0=True).items()}
    t["h0"] = t["h0"].to(torch.bfloat16)  # a bf16 h0 is read in fp32
    before = rglru_scan.launches
    y, h = ops.rglru(**t)
    assert rglru_scan.launches == before  # no kernel launch on the CPU
    want_y, want_h = ref.rglru_ref(**t)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


def test_rglru_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the kernel's wrapper: only ops.rglru picks the
    plain version, and only for a CPU tensor."""
    t = {k: to_torch(v) for k, v in rglru_np(1, 4, 32).items()}
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan.rglru_scan(**t)


def test_ops_rglru_refuses_other_devices():
    """A meta tensor takes the shape function (the dry run's route); a
    device with no kernel, plain version or shape function raises."""
    t = {k: elsewhere(to_torch(v)) for k, v in rglru_np(1, 4, 32).items()}
    with pytest.raises(ValueError, match="device"):
        ops.rglru(**t)
