"""PyTorch port, flash attention: the port's plain version against the JAX
reference and the Pallas kernel (interpret mode), and the CPU dispatch of
``ops.flash_attention`` (the hand-written kernel against its plain version
is ``test_torch_flash_cuda.py``, on a card).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: fp32 2e-5 (same arithmetic, another order of operations), bf16
2e-2 (both round the scores' product and the probabilities to bf16, at
places that differ between the two frameworks' CPU kernels).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from tests.hypothesis_optional import given, settings, st

from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.babeltrace import CTFSource as JaxCTFSource
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.babeltrace import CTFSource
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.kernels import flash_attention, ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def qkv_np(B, S, T, H, Kv, d, dtype="float32", seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16" else (lambda a: a)
    shapes = {"q": (B, S, H, d), "k": (B, T, Kv, d), "v": (B, T, Kv, d)}
    return {
        n: cast((rng.normal(size=sh) * (1.0 if n == "v" else scale)).astype(np.float32))
        for n, sh in shapes.items()
    }


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


SWEEP = [  # B, S, T, H, Kv, d, window (causal): tests/test_kernels.py's sweep
    (1, 32, 32, 4, 4, 32, None),  # MHA
    (2, 64, 64, 8, 2, 16, None),  # GQA 4:1
    (2, 64, 64, 4, 1, 32, None),  # MQA
    (1, 48, 48, 2, 2, 64, 16),  # SWA
    (1, 16, 64, 4, 2, 32, None),  # a query block shorter than the keys
    (3, 128, 128, 2, 1, 8, 32),
]
MORE = [  # B, S, T, H, Kv, d, causal, window
    (2, 32, 32, 4, 2, 16, False, None),  # non-causal
    (1, 48, 48, 4, 2, 16, False, 12),  # a window without causal
    (1, 24, 8, 4, 2, 16, True, None),  # S > T: the first 16 rows keep no key
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,Kv,d,window", SWEEP)
def test_flash_ref_matches_jax_ref(B, S, T, H, Kv, d, window, dtype):
    jd, td = both(qkv_np(B, S, T, H, Kv, d, dtype))
    want = jref.flash_attention_ref(**jd, causal=True, window=window)
    got = ref.flash_attention_ref(**td, causal=True, window=window)
    assert got.dtype == td["q"].dtype and tuple(got.shape) == (B, S, H, d)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,Kv,d,causal,window", MORE)
def test_flash_ref_matches_jax_ref_off_the_sweep(B, S, T, H, Kv, d, causal, window, dtype):
    jd, td = both(qkv_np(B, S, T, H, Kv, d, dtype, seed=1))
    want = jref.flash_attention_ref(**jd, causal=causal, window=window)
    got = ref.flash_attention_ref(**td, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize(
    "B,S,T,H,Kv,d,window",
    [
        (1, 32, 32, 4, 4, 32, None),  # MHA
        (2, 64, 64, 8, 2, 16, None),  # GQA
        (1, 48, 48, 2, 2, 64, 16),  # SWA
        (1, 24, 8, 4, 2, 16, None),  # S > T
    ],
)
def test_flash_ref_matches_the_pallas_kernel(B, S, T, H, Kv, d, window):
    jd, td = both(qkv_np(B, S, T, H, Kv, d, seed=2))
    want = flash_attention_pallas(**jd, causal=True, window=window, blk_q=8, blk_k=8, interpret=True)
    got = ref.flash_attention_ref(**td, causal=True, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


def test_rows_with_no_key_are_the_mean_of_v():
    """S > T under causal: the masked scores are the finite -1e30, so a row
    before the first key has a uniform softmax, the mean of v over all T
    keys (what the Pallas kernel gives too), not zero."""
    td = {k: to_torch(v) for k, v in qkv_np(1, 24, 8, 4, 2, 16, seed=3).items()}
    got = ref.flash_attention_ref(**td, causal=True)
    mean_v = td["v"].mean(dim=1).repeat_interleave(2, dim=1)  # [B, H, d]
    for row in range(16):
        np.testing.assert_allclose(f32(got[:, row]), f32(mean_v), **TOL["float32"])


@settings(max_examples=10, deadline=None)
@given(scale=st.floats(min_value=0.1, max_value=8.0))
def test_flash_ref_matches_jax_ref_over_input_scale(scale):
    """Large scores (scale 8: |s| up to ~200) do not break the fp32 softmax."""
    jd, td = both(qkv_np(1, 64, 64, 2, 2, 16, seed=4, scale=scale))
    want = jref.flash_attention_ref(**jd, causal=True, window=24)
    got = ref.flash_attention_ref(**td, causal=True, window=24)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-5, atol=3e-5)


def _flash_span_payloads(source_cls, trace_dir):
    keys = ("grid_x", "grid_y", "grid_z", "flops", "bytes_accessed")
    return [
        tuple(e.field(k) for k in keys)
        for e in source_cls(trace_dir)
        if e.name == "ust_kernel:launch_span" and e.field("name") == "flash_attention"
    ]


def test_ops_flash_attention_on_cpu_runs_the_plain_version_under_a_span(tmp_path):
    """One ``ust_kernel:launch`` ``flash_attention`` span per call, with the
    JAX package's grid, analytic FLOPs and bytes, and no kernel launch."""
    jd, td = both(qkv_np(2, 24, 24, 4, 2, 16, "bfloat16", seed=5))
    with JaxTracer(JaxTraceConfig(out_dir=str(tmp_path / "jax"), mode="default")):
        jops.flash_attention(**jd, causal=True, window=8, impl="ref")
    before = flash_attention.launches
    with Tracer(TraceConfig(out_dir=str(tmp_path / "torch"), mode="default")):
        got = ops.flash_attention(**td, causal=True, window=8)
    assert flash_attention.launches == before
    assert torch.equal(got, ref.flash_attention_ref(**td, causal=True, window=8))
    want = _flash_span_payloads(JaxCTFSource, str(tmp_path / "jax"))
    assert len(want) == 1
    assert _flash_span_payloads(CTFSource, str(tmp_path / "torch")) == want
    row = tally_trace(str(tmp_path / "torch")).device_apis[("ust_kernel", "flash_attention")]
    assert row.calls == 1


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the kernel's wrapper: only ops.flash_attention
    picks the plain version, and only for a CPU tensor."""
    td = {k: to_torch(v) for k, v in qkv_np(1, 8, 8, 2, 2, 16).items()}
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(**td)


def test_ops_flash_attention_refuses_other_devices():
    td = {k: to_torch(v).to("meta") for k, v in qkv_np(1, 8, 8, 2, 2, 16).items()}
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(**td)
