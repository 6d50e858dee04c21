"""The bf16 flash-attention kernel's tiling, mirrored in Python from
``src/repro_torch/csrc/flash_attention.cu`` for the tests: the CPU tests
(``test_torch_flash_plan.py``) hold it against a brute-force mask, the card
tests (``test_torch_flash_cuda.py``) hold the CUDA source's own values to it.

Pure Python, imported by its file name (pytest puts ``tests/`` on the path),
so that it also loads where another installed package is named ``tests``.
"""

from typing import Optional

#: the bf16 kernel's block: query rows (two warpgroups of WG_ROWS), keys per
#: K/V tile, K/V tiles in the ring; and the most dynamic shared memory a
#: block may have
BQ, WG_ROWS, BK, STAGES = 128, 64, 64, 2
SMEM_LIMIT = 232_448


def padded_dim(d: int) -> int:
    """The bf16 tiles' row width: d rounded up to the 64 columns of one
    128-byte swizzled row."""
    return -(-d // 64) * 64


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one bf16 block: the Q tile and two stages of
    K and V, plus 1 KB to align the base to the swizzle pattern."""
    return (BQ + 2 * STAGES * BK) * padded_dim(d) * 2 + 1024


def grid(B: int, S: int, H: int) -> tuple:
    """The bf16 kernel's grid: one block per (128-row query tile, head, batch)."""
    return (-(-S // BQ), H, B)


def row_keys(row: int, S: int, T: int, causal: bool, window: Optional[int]) -> tuple:
    """The keys ``[lo, hi)`` query row ``row`` keeps (none when hi <= lo)."""
    qpos = row + T - S
    lo, hi = 0, T
    if causal:
        hi = min(hi, qpos + 1)
    if window is not None:
        lo = max(lo, qpos - window + 1)
    return min(lo, T), max(hi, 0)


def band(r0: int, r1: int, S: int, T: int, causal: bool, window: Optional[int]) -> tuple:
    """``(lo, hi, all_lo, all_hi)`` for query rows ``[r0, r1)``: the keys some
    row keeps are ``[lo, hi)`` (none when hi <= lo; causal with a window of 0
    or less keeps none), and a key tile inside ``[all_lo, all_hi)`` is kept
    whole by every row.  The kernel visits the tiles of BK keys from
    ``lo // BK * BK`` while below ``hi``."""
    first_lo, first_hi = row_keys(r0, S, T, causal, window)
    last_lo, last_hi = row_keys(r1 - 1, S, T, causal, window)
    hi = first_lo if causal and window is not None and window <= 0 else last_hi
    return first_lo, hi, last_lo, first_hi
