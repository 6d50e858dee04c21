"""RG-LRU fused gates and linear recurrence on Hopper: the wrapper of
``csrc/rglru_scan.cu``.

Replaces the TPU kernel ``src/repro/kernels/rglru_scan.py::rglru_pallas`` and
computes what ``ref.rglru_ref`` computes.  The design (a time-chunked scan
whose carry crosses a thread-block cluster) and its bound are noted in the
CUDA source.  One call is one launch and counts once in :data:`launches`.

``x``, ``r`` and ``i`` are ``[B,S,C]`` in one dtype (fp32 or bf16), ``lam``
is ``[C]`` (read in fp32), ``h0`` is ``[B,C]`` or None and is read in fp32,
as the Pallas kernel's ``.astype(f32)`` does.  Returns ``y`` in x's dtype and
``h_last [B,C]`` fp32.

:func:`kernel_plan` reads the launch's tiling from the CUDA source
(``rglru_scan_plan``), for the card tests to hold against the mirror that
``tests/test_torch_rglru_chunks.py`` checks on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _checks

#: the kernel's grid has one row per batch entry (CUDA's grid.y limit)
MAX_BATCH = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (a caller resets it by assignment)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        lib.rglru_scan_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.rglru_scan_plan.restype = ctypes.c_int
    return lib


def kernel_plan(dtype: torch.dtype, B: int, S: int, C: int) -> dict:
    """The CUDA source's own kernel and tiling of one launch (builds the
    library): ``step`` 1 for the step kernel (S <= ``sub_steps``)."""
    out = (ctypes.c_int * 10)()
    if dtype not in _DTYPE_CODE or _lib().rglru_scan_plan(_DTYPE_CODE[dtype], B, S, C, out) != 0:
        raise ValueError(f"rglru_scan_plan refused dtype={dtype} B={B} S={S} C={C}")
    keys = ("step", "cluster", "rounds", "tile", "grid_x", "grid_y", "threads", "sub_steps", "chunk", "smem")
    return dict(zip(keys, out))


def rglru_scan(
    x: torch.Tensor,
    r: torch.Tensor,
    i: torch.Tensor,
    lam: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """Launch the RG-LRU kernel on CUDA tensors; raises on anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rglru_scan: x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if x.ndim != 3:
        raise ValueError(f"rglru_scan: x must be [B,S,C], got shape {tuple(x.shape)}")
    B, S, C = x.shape
    if not (1 <= B <= MAX_BATCH and S >= 1 and C >= 1):
        raise ValueError(f"rglru_scan: needs 1 <= B <= {MAX_BATCH}, S >= 1, C >= 1; got {B, S, C}")
    dev = x.device
    for name, t in (("x", x), ("r", r), ("i", i)):
        _checks.check("rglru_scan", name, t, (B, S, C), x.dtype, dev)
    lam = lam.float().contiguous()
    _checks.check("rglru_scan", "lam", lam, (C,), torch.float32, dev)
    if h0 is not None:
        h0 = h0.float()
        _checks.check("rglru_scan", "h0", h0, (B, C), torch.float32, dev)
    y = torch.empty_like(x)
    h_last = torch.empty((B, C), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_scan_launch(
            _DTYPE_CODE[x.dtype],
            x.data_ptr(),
            r.data_ptr(),
            i.data_ptr(),
            lam.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            y.data_ptr(),
            h_last.data_ptr(),
            B, S, C,
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"rglru_scan launch failed: CUDA error {rc} "
            f"({lib.rglru_scan_error_string(rc).decode()})"
        )
    launches += 1
    return y, h_last
