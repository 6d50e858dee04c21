"""Mamba2 SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_pallas`` and
computes what ``ref.ssd_ref`` computes, ``state0`` included (applied to
``y`` and to the final state).  The design and its bound are noted in the
CUDA source.

Layouts are the JAX package's: ``x [B,S,H,P]`` and ``Bm``/``Cm``
``[B,S,G,N]`` in one dtype (fp32 or bf16), ``dt [B,S,H]`` fp32,
``A_log``/``D`` ``[H]``, ``state0 [B,H,P,N]`` fp32 or None.  Returns
``y`` in x's dtype and the final state ``[B,H,P,N]`` fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

#: the kernel's compile-time head width and state size (Mamba2-1.3B's)
HEAD_DIM = 64
D_STATE = 128
#: longest chunk the kernel takes (its shared-memory cumsum holds 256 steps)
MAX_CHUNK = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (a caller resets it by assignment)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise ValueError(f"ssd_scan: {name} has dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"ssd_scan: {name} must be contiguous")


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A_log: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int,
    state0: Optional[torch.Tensor] = None,
):
    """Launch the SSD kernel on CUDA tensors; raises on anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"ssd_scan: x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if P != HEAD_DIM or N != D_STATE:
        raise ValueError(
            f"ssd_scan is built for head_dim={HEAD_DIM}, d_state={D_STATE}; got P={P}, N={N}"
        )
    if not 0 < chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be in (0, {MAX_CHUNK}] and divide S={S}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: heads {H} must divide into groups {G}")
    dev = x.device
    _check("x", x, (B, S, H, P), x.dtype, dev)
    _check("dt", dt, (B, S, H), torch.float32, dev)
    _check("Bm", Bm, (B, S, G, N), x.dtype, dev)
    _check("Cm", Cm, (B, S, G, N), x.dtype, dev)
    # [H] per-head scalars: the kernel reads them in fp32 (as ssd_ref does)
    A_log = A_log.float().contiguous()
    D = D.float().contiguous()
    _check("A_log", A_log, (H,), torch.float32, dev)
    _check("D", D, (H,), torch.float32, dev)
    if state0 is not None:
        _check("state0", state0, (B, H, P, N), torch.float32, dev)
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            _DTYPE_CODE[x.dtype],
            x.data_ptr(),
            dt.data_ptr(),
            A_log.data_ptr(),
            Bm.data_ptr(),
            Cm.data_ptr(),
            D.data_ptr(),
            None if state0 is None else state0.data_ptr(),
            y.data_ptr(),
            final.data_ptr(),
            B, S, H, G, P, N, chunk,
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ssd_scan launch failed: CUDA error {rc} "
            f"({lib.ssd_scan_error_string(rc).decode()})"
        )
    launches += 1
    return y, final
