"""Tracing session control (THAPI §3.2, §5.2).

The tracer owns the collection side of the framework:

  * **modes** — ``minimal`` / ``default`` / ``full`` (§5.2): minimal traces
    device-side events only (kernel executions, device commands), default
    traces everything except polling / spin-lock APIs ("non-spawned APIs"),
    full traces everything including polled calls and argument dumps;
  * **selective events / ranks** — per-event enable flags and a rank filter
    ("trace specific groups of ranks in a large-scale setting", §3.2);
  * **consumer daemon** — drains every thread's ring buffer to CTF-lite
    streams on a period (LTTng's consumer/relay daemon), emitting
    discarded-event records when drop counters advance.

The live-analysis knobs (online tally, streaming masters, adaptive and
remediation control, aggregate-only and columnar output) need modules that
are not ported yet: setting any of them raises ``NotImplementedError``.

Usage:

    cfg = TraceConfig(out_dir="/tmp/t", mode="default", sample=True)
    with Tracer(cfg) as tr:
        ...traced application...
    handle = tr.handle  # → analysis (tally)
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
import threading
from typing import Dict, Optional, Sequence, Set, Tuple

from . import telemetry as _telemetry
from .api_model import TraceModel, builtin_trace_model
from .clock import ClockInfo, now
from .ctf import StreamWriter, trace_size_bytes, write_metadata
from .ringbuffer import RingRegistry
from .tracepoints import FIDELITY_MODES, Tracepoints

MODES = ("minimal", "default", "full")

#: TraceConfig fields whose modules are not ported yet; each must stay at its
#: "off" value
_UNPORTED = (
    "online",
    "stream_to",
    "serve_port",
    "adaptive",
    "cluster_adaptive",
    "aggregate_only",
    "columnar",
    "remediation",
)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported in a later slice, see ROADMAP.md")


@dataclasses.dataclass
class TraceConfig:
    out_dir: str
    mode: str = "default"
    sample: bool = False  # device telemetry daemon (TS-* configurations)
    sample_period_s: float = 0.05  # paper default: 50 ms (§3.5)
    ring_bytes: int = 1 << 22  # 4 MiB per thread
    flush_period_s: float = 0.05
    rank: int = 0
    #: §3.2 — trace only these ranks (None = all). Non-selected ranks run untraced.
    ranks: Optional[Sequence[int]] = None
    #: escape hatch: False reverts recorders to the legacy bytes-build +
    #: RingBuffer.write path (byte-identical streams; see core/tracepoints.py)
    ring_reserve: bool = True
    #: zstd-compress CTF streams (space knob beyond Fig 8's mode ladder)
    compress: bool = False
    #: extra per-event overrides applied after the mode preset, e.g.
    #: {"ust_torchrt:alloc_entry": False}
    event_overrides: Optional[Dict[str, bool]] = None
    #: starting rung of the fidelity ladder: "full" | "sampled" | "off"
    #: ("tally-only" needs the online analyzer, not ported yet)
    fidelity: str = "full"
    #: 1/N systematic-sampling interval for the "sampled" rung
    sampling_interval: int = 64
    #: seed for the per-thread sampling phase RNG (None = nondeterministic)
    sampling_seed: Optional[int] = None
    # -- not ported yet: any value but the default raises --------------------
    online: bool = False
    stream_to: Optional[str] = None
    serve_port: Optional[int] = None
    adaptive: Optional[Sequence] = None
    cluster_adaptive: Optional[Sequence] = None
    aggregate_only: bool = False
    columnar: bool = False
    remediation: Optional[object] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.fidelity not in FIDELITY_MODES:
            raise ValueError(
                f"fidelity must be one of {FIDELITY_MODES}, got {self.fidelity!r}"
            )
        if self.sampling_interval < 1:
            raise ValueError("sampling_interval must be >= 1")
        for name in _UNPORTED:
            value = getattr(self, name)
            if value is not None and value is not False:  # serve_port=0 is a port
                raise _unported(f"TraceConfig.{name}")
        if self.fidelity == "tally-only":
            raise _unported('fidelity "tally-only"')


def events_for_mode(model: TraceModel, mode: str, sample: bool) -> Set[int]:
    """Mode → enabled event-id set (§5.2 definitions).

    minimal : kernel execution + device command events (device spans).
    default : every event except polling ("non-spawned") APIs.
    full    : everything.
    Telemetry counters ride on ``sample`` independent of the mode (T- vs TS-).
    """
    out: Set[int] = set()
    for ev in model.events:
        if ev.phase == "meta":
            continue
        if ev.provider == "ust_thapi":
            if sample:
                out.add(ev.eid)
            continue
        if mode == "minimal":
            if ev.phase == "span":
                out.add(ev.eid)
        elif mode == "default":
            if not ev.polling:
                out.add(ev.eid)
        else:  # full
            out.add(ev.eid)
    return out


# Global tracepoints singleton over the builtin trace model. Interception
# code references these recorder callables directly (no per-call lookups).
_TRACEPOINTS: Optional[Tracepoints] = None
_TP_LOCK = threading.Lock()


def get_tracepoints() -> Tracepoints:
    global _TRACEPOINTS
    if _TRACEPOINTS is None:
        with _TP_LOCK:
            if _TRACEPOINTS is None:
                _TRACEPOINTS = Tracepoints(builtin_trace_model())
    return _TRACEPOINTS


_ACTIVE: Optional["Tracer"] = None


def active_tracer() -> Optional["Tracer"]:
    return _ACTIVE


@dataclasses.dataclass
class TraceHandle:
    """Result of a completed session, input to the analysis layer."""

    trace_dir: str
    mode: str
    events: int
    dropped: int
    size_bytes: int
    #: fidelity rung at stop time (see TraceConfig.fidelity)
    fidelity: str = "full"


class Tracer:
    def __init__(
        self,
        cfg: TraceConfig,
        model: Optional[TraceModel] = None,
        clock=None,
    ):
        self.cfg = cfg
        #: ``clock`` (injectable timestamp source, tests only) is honored when
        #: a private model is supplied — the global recorder singleton always
        #: runs on the trace clock
        self.tp = get_tracepoints() if model is None else Tracepoints(model, clock=clock)
        self.model = self.tp.model
        self.clock: Optional[ClockInfo] = None
        self.registry: Optional[RingRegistry] = None
        self.handle: Optional[TraceHandle] = None
        self._writers: Dict[Tuple[int, int], StreamWriter] = {}
        self._consumer: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._sampler: Optional[_telemetry.TelemetryDaemon] = None
        self._started = False
        #: rank selected for tracing? (§3.2 selective rank tracing)
        self.selected = cfg.ranks is None or cfg.rank in set(cfg.ranks)
        #: fidelity-ladder state: current rung, rungs visited this session
        #: (stamped into the trace metadata so the analysis side knows
        #: whether scaled estimates are exact), and the lock serializing
        #: drains against mid-run rung flips
        self._fidelity = cfg.fidelity
        self._modes_used = [cfg.fidelity]
        self._drain_lock = threading.Lock()

    # -- properties used by the interception layer ---------------------------
    @property
    def mode(self) -> str:
        return self.cfg.mode

    @property
    def fidelity(self) -> str:
        return self._fidelity

    @property
    def full(self) -> bool:
        return (
            self.cfg.mode == "full"
            and self._fidelity != "off"
            and self.selected
            and self._started
        )

    # -- fidelity ladder ------------------------------------------------------
    def set_mode(self, mode: str) -> str:
        """Move the session to another rung of the fidelity ladder mid-run;
        returns the previous rung.

        Records already published are drained under the *outgoing* rung's
        policy before the recorders flip, and the flip itself is one atomic
        ``__code__`` store per recorder, so no drain ever observes a torn or
        reordered record.
        """
        if mode not in FIDELITY_MODES:
            raise ValueError(f"unknown fidelity {mode!r} (want one of {FIDELITY_MODES})")
        if mode == "tally-only":
            raise _unported('fidelity "tally-only"')
        if not self._started:
            raise RuntimeError("tracer not started")
        if not self.selected:  # untraced rank: track the rung, nothing to flip
            prev, self._fidelity = self._fidelity, mode
            return prev
        with self._drain_lock:
            prev = self._fidelity
            if mode == prev:
                return prev
            self._drain_unlocked()  # pending records leave under the old policy
            self.tp.set_fidelity(mode, interval=self.cfg.sampling_interval)
            self._fidelity = mode
            if mode not in self._modes_used:
                self._modes_used.append(mode)
        # one advisory per rung change, recorded into the trace itself; a
        # flip to "off" records nothing by construction
        rec = self.tp.record.get("ust_repro:advisory")
        if rec is not None:
            rec("fidelity", "set_mode", f"{prev}->{mode}")
        return prev

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Tracer":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a tracing session is already active")
        if not self.selected:
            _ACTIVE = self  # active but disabled: recorders stay off
            self._started = True
            return self
        os.makedirs(self.cfg.out_dir, exist_ok=True)
        self.clock = ClockInfo.capture()
        self.registry = RingRegistry(self.cfg.ring_bytes, pid=os.getpid())
        enabled = events_for_mode(self.model, self.cfg.mode, self.cfg.sample)
        if self.cfg.event_overrides:
            name2ev = self.model.by_name()
            for name, on in self.cfg.event_overrides.items():
                eid = name2ev[name].eid
                (enabled.add if on else enabled.discard)(eid)
        self.tp.attach(self.registry, sorted(enabled), ring_reserve=self.cfg.ring_reserve)
        if self.cfg.fidelity != "full" or self.cfg.sampling_seed is not None:
            # seeding up front makes a later mid-run flip into "sampled"
            # deterministic too
            self.tp.set_fidelity(
                self.cfg.fidelity,
                interval=self.cfg.sampling_interval,
                seed=self.cfg.sampling_seed,
            )
        self._stop_evt.clear()
        self._consumer = threading.Thread(
            target=self._consumer_loop, name="thapi-consumer", daemon=True
        )
        self._consumer.start()
        if self.cfg.sample:
            self._sampler = _telemetry.TelemetryDaemon(
                record=self.tp.record["ust_thapi:sample"],
                period_s=self.cfg.sample_period_s,
            )
            self._sampler.start()
        self._started = True
        _ACTIVE = self
        return self

    def stop(self) -> TraceHandle:
        global _ACTIVE
        if not self._started:
            raise RuntimeError("tracer not started")
        if not self.selected:
            _ACTIVE = None
            self._started = False
            self.handle = TraceHandle(
                self.cfg.out_dir, self.cfg.mode, 0, 0, 0, fidelity=self._fidelity
            )
            return self.handle
        try:
            if self._sampler is not None:
                self._sampler.stop()
            self.tp.detach()  # stop producing before the final drain
            self._stop_evt.set()
            assert self._consumer is not None
            self._consumer.join(timeout=10.0)
            self._drain_once()  # final drain catches post-loop residue
            for w in self._writers.values():
                w.close()
            assert self.registry is not None and self.clock is not None
            write_metadata(
                self.cfg.out_dir,
                self.model,
                self.clock,
                env={
                    "hostname": socket.gethostname(),
                    "pid": os.getpid(),
                    "argv": sys.argv,
                    "rank": self.cfg.rank,
                    "sample": self.cfg.sample,
                    "fidelity": {
                        "final": self._fidelity,
                        "interval": self.cfg.sampling_interval,
                        "modes_used": list(self._modes_used),
                    },
                },
                mode=self.cfg.mode,
            )
            self.handle = TraceHandle(
                trace_dir=self.cfg.out_dir,
                mode=self.cfg.mode,
                events=self.registry.total_events,
                dropped=self.registry.total_dropped,
                size_bytes=trace_size_bytes(self.cfg.out_dir),
                fidelity=self._fidelity,
            )
        finally:
            # a failed teardown must never leave the process un-traceable
            _ACTIVE = None
            self._started = False
        return self.handle

    def __enter__(self) -> "Tracer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- consumer daemon -------------------------------------------------------
    def _drain_once(self) -> None:
        with self._drain_lock:
            self._drain_unlocked()

    def _drain_unlocked(self) -> None:
        """Drain every ring zero-copy into its stream.  A ring that has
        produced nothing (an idle thread) gets no ``StreamWriter`` — and so
        no empty ``stream_*.ctf`` file — until its first record or drop shows
        up; the ``now()`` stamp for discard records is only taken when the
        drop counter advanced.  Caller holds ``_drain_lock``."""
        assert self.registry is not None
        writers = self._writers
        for ring in self.registry.rings():
            regions = ring.drain_view()
            dropped = ring.dropped
            key = (ring.pid, ring.tid)
            w = writers.get(key)
            if w is None:
                if not regions and not dropped:
                    continue  # idle thread: defer stream-file creation
                path = os.path.join(self.cfg.out_dir, f"stream_{ring.pid}_{ring.tid}.ctf")
                w = writers[key] = StreamWriter(
                    path, ring.pid, ring.tid, compress=self.cfg.compress
                )
            if regions:
                for r in regions:
                    w.append(r)
                ring.release()
            if dropped != w.seen_dropped:
                w.note_drops(dropped, now())

    def _consumer_loop(self) -> None:
        while not self._stop_evt.wait(self.cfg.flush_period_s):
            self._drain_once()


def trace_session(out_dir: str, mode: str = "default", **kw) -> Tracer:
    """Convenience constructor mirroring ``iprof -m <mode> --sample``."""
    return Tracer(TraceConfig(out_dir=out_dir, mode=mode, **kw))
