"""Mamba2 SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_pallas`` and
computes what ``ref.ssd_ref`` computes, ``state0`` included (applied to
``y`` and to the final state).  The design and its bound are noted in the
CUDA source: bf16 runs three passes on the warpgroup tensor-core (``wgmma``)
products, with a workspace this wrapper allocates on the caller's stream;
fp32 runs the CUDA-core kernel.  One call is one launch of the C entry
point and counts once in :data:`launches`.

Layouts are the JAX package's: ``x [B,S,H,P]`` and ``Bm``/``Cm``
``[B,S,G,N]`` in one dtype (fp32 or bf16; bf16 ones start 16-byte aligned,
the kernel copies 16 bytes at a time), ``dt [B,S,H]`` fp32,
``A_log``/``D`` ``[H]``, ``state0 [B,H,P,N]`` fp32 or None.  Returns
``y`` in x's dtype and the final state ``[B,H,P,N]`` fp32.

:func:`kernel_plan` reads the bf16 passes' tiling from the CUDA source
(``ssd_scan_plan``), for the card tests to hold against the mirror that
``tests/test_torch_ssd_phases.py`` checks on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _checks

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
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        lib.ssd_scan_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.ssd_scan_workspace_bytes.restype = ctypes.c_size_t
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_plan.restype = ctypes.c_int
    return lib


def kernel_plan(B: int, S: int, H: int, chunk: int) -> dict:
    """The CUDA source's own tiling values of the bf16 passes (builds the
    library): each pass's dynamic shared-memory bytes, grid and threads."""
    out = (ctypes.c_int * 14)()
    rc = _lib().ssd_scan_plan(B, S, H, chunk, out)
    if rc != 0:
        raise ValueError(f"ssd_scan_plan refused B={B} S={S} H={H} chunk={chunk}")
    v = list(out)
    return {
        "smem": {"chunk": v[0], "state": 0, "output": v[1]},
        "grids": {
            "chunk": (tuple(v[2:5]), v[11]),
            "state": (tuple(v[5:8]), v[12]),
            "output": (tuple(v[8:11]), v[13]),
        },
    }


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
    _checks.check("ssd_scan", "x", x, (B, S, H, P), x.dtype, dev)
    _checks.check("ssd_scan", "dt", dt, (B, S, H), torch.float32, dev)
    _checks.check("ssd_scan", "Bm", Bm, (B, S, G, N), x.dtype, dev)
    _checks.check("ssd_scan", "Cm", Cm, (B, S, G, N), x.dtype, dev)
    # [H] per-head scalars: the kernel reads them in fp32 (as ssd_ref does)
    A_log = A_log.float().contiguous()
    D = D.float().contiguous()
    _checks.check("ssd_scan", "A_log", A_log, (H,), torch.float32, dev)
    _checks.check("ssd_scan", "D", D, (H,), torch.float32, dev)
    if state0 is not None:
        _checks.check("ssd_scan", "state0", state0, (B, H, P, N), torch.float32, dev)
    lib = _lib()
    ws = None
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"ssd_scan: bf16 {name} must start 16-byte aligned")
        # cum, each chunk's own state, and the state entering each chunk as
        # bf16 high and low parts, in one allocation the CUDA source lays
        # out.  Freed when this returns: the caching allocator hands the
        # memory only to later work on the same stream, which runs after
        # the passes.
        ws = torch.empty(lib.ssd_scan_workspace_bytes(B, S, H, chunk), dtype=torch.uint8, device=dev)
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
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
            None if ws is None else ws.data_ptr(),
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
