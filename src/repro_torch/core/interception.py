"""Interception library for PyTorch (THAPI §3.2–§3.3, Fig 1b "Wrapper Functions").

THAPI intercepts every API entry/exit of each programming model and records
the *complete call context* — arguments, pointers, sizes, out-values — not
just names and timestamps (§1.1's zeCommandListAppendMemoryCopy example).

Interception points of the PyTorch stack:

  ust_repro       framework API   — train / eval steps, data, optimizer,
                                    checkpoints, serve calls (prefill /
                                    decode_step)
  ust_torchrt     torch dispatch  — step dispatches and first-call
                                    "compiles", CUDA-event fences, h2d/d2h
                                    copies and allocations
  ust_kernel      device layer    — step, kernel and transfer spans
  ust_collective  communication   — all-reduce and the other collectives

Pointer convention reproduced from the paper: host addresses start ``0x00``,
device addresses ``0xff`` — so analysis can deduce H2D vs D2H from the
address classes alone.

Everything here no-ops at one branch when tracing is off: the recorders
generated by tracepoints.py check their enable flag first, and the wrapper
fast paths check ``active_tracer()`` once.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .clock import now
from .telemetry import TransferGauge
from .tracer import active_tracer, get_tracepoints

# Transfer kinds (ust_torchrt:memcpy / ust_kernel:transfer `kind` field)
H2D, D2H, D2D = 0, 1, 2

_DEVICE_PTR_TAG = 0xFF00_0000_0000_0000
_PTR_MASK = 0x0000_FFFF_FFFF_FFFF


def host_ptr(x: Any) -> int:
    """Host address (0x00-prefixed): a numpy array's or a tensor's buffer."""
    if isinstance(x, np.ndarray):
        return x.ctypes.data & _PTR_MASK
    return x.data_ptr() & _PTR_MASK


def device_ptr(x: torch.Tensor) -> int:
    """0xff-tagged device address of a tensor's storage (§1.1 convention)."""
    return _DEVICE_PTR_TAG | (x.data_ptr() & _PTR_MASK)


def _tensors(tree: Any) -> list:
    """The tensors of a nested dict/list/tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def nbytes_of(tree: Any) -> int:
    """Bytes held by the tensors of a nested dict/list/tuple."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _TP:
    """Late-bound recorder bundle (single global trace model)."""

    def __init__(self):
        tps = get_tracepoints()
        r = tps.record
        self.dispatch_entry = r["ust_torchrt:dispatch_entry"]
        self.dispatch_exit = r["ust_torchrt:dispatch_exit"]
        self.compile_entry = r["ust_torchrt:compile_entry"]
        self.compile_exit = r["ust_torchrt:compile_exit"]
        self.block_entry = r["ust_torchrt:block_until_ready_entry"]
        self.block_exit = r["ust_torchrt:block_until_ready_exit"]
        # fused entry/exit pairs: one ring reservation for both records,
        # where the wrapper holds all exit values when it records
        p = tps.record_pair
        self.memcpy_pair = p["ust_torchrt:memcpy"]
        self.alloc_pair = p["ust_torchrt:alloc"]
        self.poll_pair = p["ust_repro:poll_ready"]
        self.kernel_span = r["ust_kernel:launch_span"]
        self.transfer_span = r["ust_kernel:transfer_span"]
        self.coll = {
            k: r[f"ust_collective:{k}_span"]
            for k in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast", "barrier")
        }
        self.fw = {
            name: (r[f"ust_repro:{name}_entry"], r[f"ust_repro:{name}_exit"])
            for name in (
                "train_step",
                "eval_step",
                "data_next",
                "checkpoint_save",
                "checkpoint_restore",
                "optimizer_update",
                "prefill",
                "decode_step",
            )
        }


_tp: Optional[_TP] = None


def tp() -> _TP:
    global _tp
    if _tp is None:
        _tp = _TP()
    return _tp


# ---------------------------------------------------------------------------
# ust_torchrt: traced eager step (the workhorse wrapper)
# ---------------------------------------------------------------------------


class TracedStep:
    """Eager step wrapper with THAPI interception (≙ the JAX ``TracedJit``).

    Records per call:
      * ``dispatch`` entry/exit — fn name, #args, argument bytes, donated
        bytes (the arguments of ``donate_argnums``, which the step writes
        into in place: the decode step's cache, as the JAX engine donates it)
      * ``compile`` entry/exit on the first call (cache_hit=False) — the
        first eager call is where PyTorch builds its kernels and caches
      * ``launch`` span — begin/end timestamps around execution.  On a CUDA
        ``device`` the end is fenced with a ``torch.cuda.Event`` recorded on
        the current stream: ``block_until_ready`` entry/exit around
        ``Event.synchronize()``, or in *full* mode a polling loop on
        ``Event.query()`` emitting ``poll_ready`` pairs — the spin-lock
        pattern behind zeEventHostSynchronize's 9.9M calls in the §4.3
        tally.  A CPU step has finished when it returns: no fence.
    """

    def __init__(
        self,
        fn: Callable,
        name: Optional[str] = None,
        *,
        device: torch.device,
        flops: int = 0,
        bytes_accessed: int = 0,
        donate_argnums: Sequence[int] = (),
    ):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "step")
        self.device = torch.device(device)
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.donate_argnums = frozenset(donate_argnums)
        self._sizes: Optional[tuple] = None  # (argument bytes, donated bytes) of the first call
        self._called_once = False

    def __call__(self, *args):
        tr = active_tracer()
        if tr is None or not tr.selected or tr.fidelity == "off":
            return self._fn(*args)
        t = tp()
        if self._sizes is None:
            donated = sum(nbytes_of(a) for i, a in enumerate(args) if i in self.donate_argnums)
            self._sizes = (nbytes_of(args), donated)
        arg_bytes, donated = self._sizes
        first = not self._called_once
        if first:
            t.compile_entry(self.name, hash(self.name) & 0xFFFFFFFFFFFF)
            self._called_once = True
        t.dispatch_entry(self.name, len(args), arg_bytes, donated)
        ts_begin = now()
        out = self._fn(*args)
        if first:
            t.compile_exit(0, False)
        if self.device.type == "cuda":
            self._fence(out, tr)
        t.kernel_span(ts_begin, now(), self.name, 1, 1, 1, self.flops, self.bytes_accessed)
        t.dispatch_exit(0)
        return out

    def _fence(self, out, tr) -> None:
        ev = torch.cuda.Event()
        ev.record()
        if tr.full:
            leaves = _tensors(out)
            hdl = device_ptr(leaves[-1]) if leaves else 0
            # polling fence: one fused pair record per poll, lookups hoisted
            poll = tp().poll_pair
            _now = now
            spins = 0
            while not ev.query():
                poll(hdl, _now(), False)
                spins += 1
                if spins > 4:
                    time.sleep(0)
            poll(hdl, _now(), True)
            return
        th = tp()
        th.block_entry(0)
        ev.synchronize()
        th.block_exit(0)


# ---------------------------------------------------------------------------
# ust_torchrt: traced transfers + allocation
# ---------------------------------------------------------------------------


def _fence(t: torch.Tensor) -> None:
    """Wait until the copy that made ``t`` has finished (a pageable
    host-to-card copy may return first), as ``jax.block_until_ready``."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def traced_device_put(x: Any, device: Any = "cuda", *, kind: int = H2D) -> torch.Tensor:
    """Copy ``x`` (a numpy array or a CPU tensor) to ``device`` with memcpy
    interception (the paper's running example).

    The entry payload carries the source (0x00 host) and destination (0xff
    device) pointers and the size; in full mode the first 32 payload bytes
    are dumped (``ArgDump`` meta-parameter — "values behind pointers",
    §1.1).  The copy is fenced before the exit stamp.
    """
    src_t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    tr = active_tracer()
    if tr is None or not tr.selected or tr.fidelity == "off":
        out = src_t.to(device, copy=True)
        _fence(out)
        return out
    t = tp()
    nb = src_t.numel() * src_t.element_size()
    src = host_ptr(x) if kind == H2D else device_ptr(src_t)
    head = x.tobytes()[:32] if tr.full and isinstance(x, np.ndarray) else b""
    ts_begin = now()
    out = src_t.to(device, copy=True)
    _fence(out)
    ts_end = now()
    # fused pair: one ring reservation frames entry+exit; the entry keeps the
    # pre-copy timestamp
    t.memcpy_pair(src, device_ptr(out), nb, kind, head, ts_begin, 0)
    t.transfer_span(ts_begin, ts_end, nb, kind)
    TransferGauge.bump_memcpy(nb)
    return out


def traced_device_get(x: torch.Tensor) -> np.ndarray:
    """Card → host readback into a numpy array, traced as a D2H memcpy."""
    tr = active_tracer()
    if tr is None or not tr.selected or tr.fidelity == "off":
        return x.detach().cpu().numpy()
    t = tp()
    nb = x.numel() * x.element_size()
    ts_begin = now()
    out = x.detach().to("cpu", copy=True).numpy()  # a blocking copy into pageable memory
    ts_end = now()
    t.memcpy_pair(device_ptr(x), host_ptr(out), nb, D2H, b"", ts_begin, 0)
    t.transfer_span(ts_begin, ts_end, nb, D2H)
    TransferGauge.bump_memcpy(nb)
    return out


def record_alloc(nbytes: int, device: int = 0) -> int:
    """Record an allocation of ``nbytes`` on ``device`` as an alloc pair;
    returns its synthetic 0xff device pointer."""
    tr = active_tracer()
    ts = now()
    ptr = _DEVICE_PTR_TAG | (ts & _PTR_MASK)
    if tr is not None and tr.selected and tr.fidelity != "off":
        tp().alloc_pair(nbytes, device, ts, ptr)
        TransferGauge.bump_alloc(nbytes)
    return ptr


# ---------------------------------------------------------------------------
# ust_kernel spans
# ---------------------------------------------------------------------------


@contextmanager
def kernel_span(name: str, grid: Sequence[int] = (1, 1, 1), flops: int = 0, bytes_accessed: int = 0):
    """Span around a hand-written kernel's call.  Eager PyTorch records one
    per call (JAX records one per trace); a CUDA launch is asynchronous, so
    on the card the span covers the enqueue, and the step's fenced launch
    span carries the device time."""
    tr = active_tracer()
    if tr is None or not tr.selected or tr.fidelity == "off":
        yield
        return
    gx, gy, gz = (tuple(grid) + (1, 1, 1))[:3]
    rec = tp().kernel_span  # hoisted: no lookups on the span exit path
    _now = now
    ts_begin = _now()
    yield
    rec(ts_begin, _now(), name, gx, gy, gz, flops, bytes_accessed)


@contextmanager
def collective_span(kind: str, nbytes: int, axis: str, n_devices: int):
    """Span around a collective (``all_reduce``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``, ``broadcast`` or ``barrier``) over
    ``n_devices`` members of the group ``axis``."""
    tr = active_tracer()
    if tr is None or not tr.selected or tr.fidelity == "off":
        yield
        return
    rec = tp().coll[kind]
    _now = now
    ts_begin = _now()
    yield
    if kind == "broadcast":
        rec(ts_begin, _now(), nbytes, 0, n_devices)
    elif kind == "barrier":
        rec(ts_begin, _now(), axis, n_devices)
    else:
        rec(ts_begin, _now(), nbytes, axis, n_devices)


# ---------------------------------------------------------------------------
# ust_repro framework spans (≙ OMPT callbacks layer)
# ---------------------------------------------------------------------------


class _FrameworkSpan:
    """Entry/exit pair with OutScalar exit fields (Fig 3 meta-parameters).

    ``outs`` is filled by the caller before exit; missing outs default to 0.
    """

    __slots__ = ("_exit_rec", "_out_names", "outs", "_on")

    def __init__(self, api: str, entry_args: tuple, out_names: tuple):
        tr = active_tracer()
        self._on = tr is not None and tr.selected and tr.fidelity != "off"
        self._out_names = out_names
        self.outs: Dict[str, Any] = {}
        if self._on:
            entry_rec, self._exit_rec = tp().fw[api]
            entry_rec(*entry_args)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if self._on:
            status = 0 if et is None else 1
            vals = [self.outs.get(n, 0) for n in self._out_names]
            self._exit_rec(status, *vals)
        return False


def train_step_span(step: int, global_batch: int, seq_len: int) -> _FrameworkSpan:
    return _FrameworkSpan("train_step", (step, global_batch, seq_len), ("loss", "grad_norm"))


def eval_step_span(step: int, global_batch: int) -> _FrameworkSpan:
    return _FrameworkSpan("eval_step", (step, global_batch), ("loss",))


def data_next_span(step: int) -> _FrameworkSpan:
    return _FrameworkSpan("data_next", (step,), ("tokens",))


def checkpoint_save_span(step: int, path: str, nbytes: int) -> _FrameworkSpan:
    return _FrameworkSpan("checkpoint_save", (step, path, nbytes), ())


def checkpoint_restore_span(path: str) -> _FrameworkSpan:
    return _FrameworkSpan("checkpoint_restore", (path,), ("step",))


def optimizer_update_span(step: int) -> _FrameworkSpan:
    return _FrameworkSpan("optimizer_update", (step,), ("lr",))


def prefill_span(request_id: int, batch: int, seq_len: int) -> _FrameworkSpan:
    return _FrameworkSpan("prefill", (request_id, batch, seq_len), ())


def decode_step_span(request_id: int, batch: int, cache_len: int) -> _FrameworkSpan:
    return _FrameworkSpan("decode_step", (request_id, batch, cache_len), ("tokens_out",))
