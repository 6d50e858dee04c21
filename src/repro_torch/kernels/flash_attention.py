"""Causal / sliding-window GQA flash-attention forward on Hopper: the wrapper
of ``csrc/flash_attention.cu``.

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_pallas`` and computes
what ``ref.flash_attention_ref`` computes.  The design and its bound are
noted in the CUDA source: bf16 runs the warpgroup tensor-core (``wgmma``)
kernel, fp32 the CUDA-core one.

``q`` is ``[B,S,H,d]``, ``k`` and ``v`` are ``[B,T,Kv,d]``, all in one dtype
(fp32 or bf16) and contiguous, with ``H % Kv == 0`` and ``d`` one of
:data:`HEAD_DIMS`; bf16 tensors start 16-byte aligned (the kernel copies 16
bytes at a time).  Returns ``o [B,S,H,d]`` in q's dtype.

:func:`kernel_plan` reads the bf16 kernel's tiling from the CUDA source
(``flash_attention_plan``), for the card tests to hold against the mirror
that ``tests/test_torch_flash_plan.py`` checks on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _checks

#: the head widths the kernel is instantiated for: the JAX kernel tests'
#: widths, 80 (h2o-danube-1.8b, stablelm-3b) and 128 (qwen1.5-32b,
#: mistral-large-123b)
HEAD_DIMS = (8, 16, 32, 64, 80, 128)
#: the kernel's grid has one z-row per batch entry and one y-row per head
#: (CUDA's grid.y and grid.z limit)
MAX_GRID_YZ = 65535
_INT32_MAX = 2**31 - 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (a caller resets it by assignment)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_plan.restype = ctypes.c_int
    return lib


def kernel_plan(d: int, S: int, T: int, causal: bool, window: Optional[int], qt: int) -> dict:
    """The CUDA source's own tiling values for head width ``d`` and query
    tile ``qt`` (builds the library): padded width, shared-memory bytes, and
    the ``band`` of the block and of its two warpgroups (zeros for a
    warpgroup with no row below S)."""
    out = (ctypes.c_int * 14)()
    has_window = window is not None
    rc = _lib().flash_attention_plan(d, S, T, int(causal), int(has_window),
                                     int(window) if has_window else 0, qt, out)
    if rc != 0:
        raise ValueError(f"flash_attention_plan refused d={d} S={S} T={T} qt={qt}")
    v = list(out)
    return {"dp": v[0], "smem": v[1], "block": tuple(v[2:6]),
            "warpgroups": (tuple(v[6:10]), tuple(v[10:14]))}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors; raises on anything
    it does not take."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(
            f"flash_attention: q must be [B,S,H,d] and k [B,T,Kv,d], got shapes "
            f"{tuple(q.shape)} and {tuple(k.shape)}"
        )
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not (1 <= B <= MAX_GRID_YZ and 1 <= H <= MAX_GRID_YZ and S >= 1 and T >= 1 and Kv >= 1):
        raise ValueError(
            f"flash_attention: needs 1 <= B, H <= {MAX_GRID_YZ}, S, T, Kv >= 1; got {B, S, H, T, Kv}"
        )
    if H % Kv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of Kv={Kv}")
    if window is not None and not -_INT32_MAX <= window <= _INT32_MAX:
        raise ValueError(f"flash_attention: window {window} outside the int32 range")
    dev = q.device
    _checks.check("flash_attention", "q", q, (B, S, H, d), q.dtype, dev, ref="q")
    for name, t in (("k", k), ("v", v)):
        _checks.check("flash_attention", name, t, (B, T, Kv, d), q.dtype, dev, ref="q")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: bf16 {name} must start 16-byte aligned")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype],
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            o.data_ptr(),
            B, S, T, H, Kv, d,
            int(causal),
            int(window is not None),
            0 if window is None else int(window),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention launch failed: CUDA error {rc} "
            f"({lib.flash_attention_error_string(rc).decode()})"
        )
    launches += 1
    return o
