"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each source compiles alone with ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>.so`` at the root of the checkout, exposing a plain
C interface that the wrappers bind with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  A library newer than its source and than every
header under ``csrc/`` (``*.cuh``, which the sources include) is reused; a fresh
build goes to a temporary file renamed into place, so processes building
the same library at once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
#: <checkout>/build/kernels (this file is <checkout>/src/repro_torch/kernels/_build.py)
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_CSRC))), "build", "kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: compiler output (``-Xptxas -v``: registers, shared memory, spills) per library
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _newest_input(src: str) -> float:
    """The latest modification time of ``src`` and of the headers under ``csrc/``."""
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in (src, *headers))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; returns its path."""
    src = os.path.join(_CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= _newest_input(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build(name))
        return lib
