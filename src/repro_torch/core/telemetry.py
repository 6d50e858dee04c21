"""Device-sampling daemon (THAPI §3.5).

THAPI's sampling framework is a daemon that polls Level-Zero Sysman counters
(energy, frequency, memory, fabric, utilization) at a user-defined period
(default 50 ms) and streams them into the LTTng trace.

Our heterogeneous devices are PyTorch devices.  On a CUDA card,
``torch.cuda.memory_stats()`` and ``torch.cuda.mem_get_info()`` expose the
caching allocator's occupancy and the card's capacity; a CPU device has no
device memory and reports zeros, leaving host counters only — the daemon
architecture (thread + period + counter events into the trace) is identical.
Host RSS and CPU% stand in for the power/frequency domains.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import torch

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_host_rss() -> int:
    """Resident set size in bytes, from /proc (no psutil dependency)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def read_device_memory(device=None) -> tuple:
    """(in_use, peak, limit) bytes for ``device`` (default: the current CUDA
    device when there is one).  A CPU device reports ``(0, 0, 0)``."""
    if device is None:
        if not torch.cuda.is_available():
            return (0, 0, 0)
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return (0, 0, 0)
    stats = torch.cuda.memory_stats(device)
    _free, total = torch.cuda.mem_get_info(device)
    return (
        int(stats.get("allocated_bytes.all.current", 0)),
        int(stats.get("allocated_bytes.all.peak", 0)),
        int(total),
    )


class StepRateGauge:
    """Shared gauge the trainer bumps each step; the daemon samples it.

    Replaces the paper's GPU utilization domains with a framework-level
    utilization signal (steps/s) that makes sense for a training runtime.
    """

    _lock = threading.Lock()
    _count = 0
    _t0 = time.monotonic()

    @classmethod
    def bump(cls, n: int = 1) -> None:
        with cls._lock:
            cls._count += n

    @classmethod
    def read_and_reset(cls) -> float:
        with cls._lock:
            t = time.monotonic()
            dt = t - cls._t0
            rate = cls._count / dt if dt > 0 else 0.0
            cls._count = 0
            cls._t0 = t
            return rate


class TransferGauge:
    """Shared byte counters the interception layer bumps on every memcpy /
    alloc; the daemon (and the stream tick) reads them as bandwidths.

    Same class-gauge pattern as :class:`StepRateGauge`: the fused pair
    recorders in ``core/interception.py`` call :meth:`bump_memcpy` /
    :meth:`bump_alloc` on the hot path (one lock + add), and
    :meth:`read_and_reset` converts the window's bytes into bytes/s.  This
    is the "transfer bandwidth from the memcpy/alloc tracepoints" evidence
    channel the remediation policies use to tell a slow kernel from a sick
    host (ROADMAP "closed-loop remediation").
    """

    _lock = threading.Lock()
    _memcpy_bytes = 0
    _alloc_bytes = 0
    _t0 = time.monotonic()

    @classmethod
    def bump_memcpy(cls, nbytes: int) -> None:
        with cls._lock:
            cls._memcpy_bytes += nbytes

    @classmethod
    def bump_alloc(cls, nbytes: int) -> None:
        with cls._lock:
            cls._alloc_bytes += nbytes

    @classmethod
    def read_and_reset(cls) -> tuple:
        """(memcpy_bytes_per_s, alloc_bytes_per_s) over the window since the
        last read; resets the window."""
        with cls._lock:
            t = time.monotonic()
            dt = t - cls._t0
            mc = cls._memcpy_bytes / dt if dt > 0 else 0.0
            al = cls._alloc_bytes / dt if dt > 0 else 0.0
            cls._memcpy_bytes = 0
            cls._alloc_bytes = 0
            cls._t0 = t
            return (mc, al)


class TelemetryDaemon:
    """Sampling thread: one ``ust_thapi:sample`` counter event per period."""

    def __init__(self, record: Callable, period_s: float = 0.05, device_index: int = 0):
        self._record = record
        self.period_s = period_s
        self.device_index = device_index
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cpu = (time.process_time(), time.monotonic())
        self.samples = 0
        self.sample_errors = 0
        self.last: dict = {}  # most recent sample, for the stream tick

    def _cpu_pct(self) -> float:
        pt, wt = time.process_time(), time.monotonic()
        lpt, lwt = self._last_cpu
        self._last_cpu = (pt, wt)
        dw = wt - lwt
        return 100.0 * (pt - lpt) / dw if dw > 0 else 0.0

    def sample_once(self) -> None:
        in_use, peak, limit = read_device_memory()
        host_rss = read_host_rss()
        cpu_pct = self._cpu_pct()
        step_rate = StepRateGauge.read_and_reset()
        memcpy_bw, alloc_bw = TransferGauge.read_and_reset()
        self.last = {
            "mem_in_use": in_use,
            "mem_peak": peak,
            "mem_limit": limit,
            "host_rss": host_rss,
            "cpu_pct": cpu_pct,
            "step_rate": step_rate,
            "memcpy_bw": memcpy_bw,
            "alloc_bw": alloc_bw,
        }
        self._record(
            self.device_index,
            in_use,
            peak,
            limit,
            host_rss,
            cpu_pct,
            step_rate,
        )
        self.samples += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            # One bad read (transient /proc or device-stats failure) must not
            # kill the daemon thread: count it and keep sampling.
            try:
                self.sample_once()
            except Exception:
                self.sample_errors += 1

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="thapi-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
