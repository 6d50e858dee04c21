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
    discarded-event records when drop counters advance;
  * **aggregate-only mode** (§3.7) — for multi-node runs keep only the tally
    aggregate (kilobytes) instead of the full streams;
  * **online analysis** (§6) — a live tally folded on the consumer thread,
    which the ``tally-only`` fidelity rung uses in place of the streams;
  * **live streaming** (§3.7+§6) — the consumer thread pushes the live tally
    to an upstream master (``stream_to``) and/or an in-process one
    (``serve_port``), and ticks the adaptive controllers (``adaptive``,
    ``cluster_adaptive``; see core/stream.py and core/adaptive.py).

The remediation loop is not ported yet: setting ``remediation`` raises
``NotImplementedError``.

Usage (the iprof CLI wraps exactly this):

    cfg = TraceConfig(out_dir="/tmp/t", mode="default", sample=True)
    with Tracer(cfg) as tr:
        ...traced application...
    handle = tr.handle  # → analysis (pretty/tally/timeline)
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
import threading
import time
from typing import Dict, Optional, Sequence, Set, Tuple

from . import telemetry as _telemetry
from .api_model import TraceModel, builtin_trace_model
from .clock import ClockInfo, now
from .ctf import StreamWriter, trace_size_bytes, write_metadata
from .ringbuffer import RingRegistry
from .tracepoints import FIDELITY_MODES, Tracepoints

MODES = ("minimal", "default", "full")

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
    #: §3.7 — keep only the aggregate tally, delete raw streams at stop().
    aggregate_only: bool = False
    #: escape hatch: False reverts recorders to the legacy bytes-build +
    #: RingBuffer.write path (byte-identical streams; see core/tracepoints.py)
    ring_reserve: bool = True
    #: zstd-compress CTF streams (space knob beyond Fig 8's mode ladder)
    compress: bool = False
    #: write a columnar ``.ctfcol`` sidecar per stream at drain time (packed
    #: interval columns + per-stream folded tally footer): repeat analysis
    #: and timeline queries then skip record parsing entirely (see
    #: core/ctf.py ColumnarWriter; staleness-checked, falls back safely)
    columnar: bool = False
    #: §6 future work, implemented: maintain a LIVE tally on the consumer
    #: thread (read via tracer.online.snapshot() mid-run)
    online: bool = False
    #: §3.7+§6 streaming: push live tally snapshots to a master at
    #: "host:port" (see core/stream.py). Implies ``online``.
    stream_to: Optional[str] = None
    #: snapshot push period; the final snapshot at stop() is always pushed
    stream_period_s: float = 0.25
    #: protocol-v2 delta streaming: ship only changed ApiStats entries in
    #: steady state (full-snapshot resync frames bound drift). Off = every
    #: push is a full snapshot (v1-compatible wire behavior).
    stream_delta: bool = True
    #: force a full-snapshot resync frame every N delta pushes
    stream_resync_every: int = 32
    #: run an in-process master on this port (0 = ephemeral) serving this
    #: rank's live tally — and, via ``stream_to`` on other ranks, theirs too;
    #: ``iprof top`` attaches here. Implies ``online``.
    serve_port: Optional[int] = None
    #: master-tree fanout used when this process is itself a master
    stream_fanout: int = 32
    #: extra per-event overrides applied after the mode preset, e.g.
    #: {"ust_torchrt:alloc_entry": False}
    event_overrides: Optional[Dict[str, bool]] = None
    #: §6 adaptive consumer: policies (or a ready AdaptiveController) ticked
    #: from the consumer thread; they may turn session knobs mid-run from
    #: live windowed metrics (see core/adaptive.py). Implies ``online``.
    adaptive: Optional[Sequence] = None
    #: adaptation window: how often the controller diffs live snapshots
    adaptive_period_s: float = 0.5
    #: cluster-scope adaptive control: ClusterPolicy list (or a ready
    #: ClusterAdaptiveController) fed from the in-process master's per-rank
    #: map and ticked from the consumer thread; requires ``serve_port``
    #: (the master IS the per-rank data source). See core/adaptive.py.
    cluster_adaptive: Optional[Sequence] = None
    #: cluster adaptation window: how often per-rank maps are diffed
    cluster_period_s: float = 1.0
    #: forward per-rank breakdowns (not collapsed composites) when this
    #: process's in-process master forwards upstream — keeps rank identity
    #: visible at every level of the aggregation tree
    stream_ranks: bool = True
    #: bearer token presented to the ``stream_to`` master (and, for an
    #: in-process master, forwarded upstream) when the serving tier runs
    #: with token auth — see core/stream.py ServeOptions.auth_tokens
    stream_token: Optional[str] = None
    #: CA bundle path pinning the upstream master's TLS certificate; sets
    #: the client side of the hardened serving tier (None = plaintext)
    stream_tls_ca: Optional[str] = None
    #: initial-connect resilience for the ``stream_to`` push client: retry
    #: the first connect up to N times with capped-exponential backoff
    #: (base ``stream_connect_backoff_s``) so ranks that start before the
    #: master don't drop their early pushes.  0 = fail fast.
    stream_connect_retries: int = 0
    stream_connect_backoff_s: float = 0.25
    #: attach per-rank device telemetry (host RSS, the card's allocator
    #: figures, memcpy/alloc bandwidth — core/telemetry.py) to every streamed
    #: snapshot, carried through the per-rank breakdown so cluster policies
    #: can tell "slow kernel" from "sick host".  Uses the sampling daemon's
    #: latest sample when ``sample`` is on, else a cheap inline read.
    stream_telemetry: bool = True
    #: full serving-tier configuration for the in-process master (TLS
    #: cert/key, auth tokens, per-tenant quotas, hub queue depth...).  None
    #: builds one from the stream_* knobs above; when set, it wins over them
    #: (it IS the knob set) and stream_token/stream_tls_ca are still
    #: injected as upstream credentials if the options carry none.
    serve_options: Optional[object] = None
    #: override the streaming source identity (None = ``default_source(rank)``,
    #: i.e. "host:pid:rankN").  A replacement process presents its
    #: predecessor's source id so the master's incarnation fencing can
    #: supersede the dead process instead of seeing a brand-new rank.
    stream_source: Optional[str] = None
    #: incarnation number carried in the streaming ``hello``/frames; masters
    #: fence frames from lower incarnations of the same source (zombie
    #: containment).  0 = the original launch.
    stream_incarnation: int = 0
    #: starting rung of the fidelity ladder (orthogonal to ``mode``, which
    #: selects *what* is traced): "full" | "sampled" | "tally-only" | "off".
    #: Switchable mid-run via Tracer.set_mode / repro_torch.trace.set_mode.
    fidelity: str = "full"
    #: 1/N systematic-sampling interval for the "sampled" rung
    sampling_interval: int = 64
    #: seed for the per-thread sampling phase RNG (None = nondeterministic)
    sampling_seed: Optional[int] = None
    #: closed-loop remediation is not ported yet: any value but None raises
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
        if self.remediation is not None:
            raise NotImplementedError(
                "TraceConfig.remediation is ported in a later slice (ROADMAP.md, "
                "modules to port: item 5, distribution and control plane)"
            )
        if self.stream_connect_retries < 0:
            raise ValueError("stream_connect_retries must be >= 0")
        if self.stream_connect_backoff_s <= 0:
            raise ValueError("stream_connect_backoff_s must be > 0")
        if self.stream_incarnation < 0:
            raise ValueError("stream_incarnation must be >= 0")
        if self.cluster_adaptive is not None and self.serve_port is None:
            raise ValueError(
                "cluster_adaptive requires serve_port: the in-process master "
                "is the per-rank data source cluster policies read"
            )
        if (
            self.stream_to is not None
            or self.serve_port is not None
            or self.adaptive is not None
        ):
            self.online = True


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
    aggregate_path: Optional[str] = None
    #: snapshots delivered / undeliverable to the stream_to master
    streamed: int = 0
    stream_dropped: int = 0
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
        #: per-stream columnar sidecar writers (cfg.columnar) + shared engine
        self._colwriters: Dict[Tuple[int, int], object] = {}
        self._fold_engine = None
        self._consumer: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._sampler: Optional[_telemetry.TelemetryDaemon] = None
        self._started = False
        self.online = None  # OnlineAnalyzer when cfg.online or on the tally-only rung
        self.streamer = None  # SnapshotStreamer when cfg.stream_to (and no serve_port)
        self.server = None  # MasterServer when cfg.serve_port
        self.adaptive = None  # AdaptiveController when cfg.adaptive
        self.cluster = None  # ClusterAdaptiveController when cfg.cluster_adaptive
        self._stream_source = ""
        self._stream_next = 0.0
        #: rank selected for tracing? (§3.2 selective rank tracing)
        self.selected = cfg.ranks is None or cfg.rank in set(cfg.ranks)
        #: fidelity-ladder state: current rung, rungs visited this session
        #: (stamped into the trace metadata so the analysis side knows
        #: whether scaled estimates are exact), and the lock serializing
        #: drains against mid-run rung flips
        self._fidelity = cfg.fidelity
        self._modes_used = [cfg.fidelity]
        self._drain_lock = threading.Lock()
        self._seen_drops: Dict[Tuple[int, int], int] = {}
        #: final in-process folded tally (set at stop() when an online
        #: analyzer ran — always the case for tally-only sessions)
        self.final_tally = None

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
            if mode == "tally-only" and self.online is None:
                from .online import OnlineAnalyzer

                self.online = OnlineAnalyzer(self.model, hostname=socket.gethostname())
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
        # tally-only folds in-process via the online analyzer even when the
        # live-tally feature itself wasn't requested
        if self.cfg.online or self.cfg.fidelity == "tally-only":
            from .online import OnlineAnalyzer

            self.online = OnlineAnalyzer(self.model, hostname=socket.gethostname())
        if self.cfg.serve_port is not None or self.cfg.stream_to is not None:
            self._start_streaming()
        if self.cfg.adaptive is not None:
            from .adaptive import build_controller

            self.adaptive = build_controller(
                self.cfg.adaptive, period_s=self.cfg.adaptive_period_s
            )
            self.adaptive.attach(self)
        if self.cfg.cluster_adaptive is not None:
            from .adaptive import build_cluster_controller

            self.cluster = build_cluster_controller(
                self.cfg.cluster_adaptive, period_s=self.cfg.cluster_period_s
            )
            self.cluster.bind(master=self.server)
            self.cluster.attach(self)  # advisories land in this rank's trace
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

    def _start_streaming(self) -> None:
        """The in-process master (``serve_port``; it forwards upstream when
        ``stream_to`` is also set, so this rank acts as a local master), or
        the leaf push client (``stream_to`` alone)."""
        from .stream import (
            MasterServer,
            ServeOptions,
            SnapshotStreamer,
            client_ssl_context,
            default_source,
        )

        cfg = self.cfg
        self._stream_source = cfg.stream_source or default_source(cfg.rank)
        if cfg.serve_port is not None:
            opts = cfg.serve_options
            if opts is None:
                opts = ServeOptions(
                    fanout=cfg.stream_fanout,
                    forward_delta=cfg.stream_delta,
                    forward_resync_every=cfg.stream_resync_every,
                    forward_ranks=cfg.stream_ranks,
                )
            # stream_token/stream_tls_ca are upstream credentials: inject
            # them unless the options already carry their own
            if cfg.stream_token is not None and opts.forward_token is None:
                opts = dataclasses.replace(opts, forward_token=cfg.stream_token)
            if cfg.stream_tls_ca is not None and opts.forward_tls_ca is None:
                opts = dataclasses.replace(opts, forward_tls_ca=cfg.stream_tls_ca)
            self.server = MasterServer(
                port=cfg.serve_port,
                forward_to=cfg.stream_to,
                forward_period_s=cfg.stream_period_s,
                options=opts,
            ).start()
        else:
            self.streamer = SnapshotStreamer(
                cfg.stream_to,
                source=self._stream_source,
                delta=cfg.stream_delta,
                resync_every=cfg.stream_resync_every,
                token=cfg.stream_token,
                ssl_context=(
                    client_ssl_context(cafile=cfg.stream_tls_ca) if cfg.stream_tls_ca else None
                ),
                connect_retries=cfg.stream_connect_retries,
                connect_backoff_s=cfg.stream_connect_backoff_s,
                incarnation=cfg.stream_incarnation,
            )

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
            self._stream_tick(final=True)  # authoritative last snapshot
            if self.streamer is not None:
                self.streamer.close()
            if self.server is not None:
                self.server.stop()  # flushes the composite upstream first
            for w in self._writers.values():
                w.close()
            for key, cw in self._colwriters.items():
                # staleness is keyed on the final on-disk stream size, so the
                # stream writer must be closed (flushed) first
                cw.close(os.path.getsize(self._writers[key].path))
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
            events = self.registry.total_events
            dropped = self.registry.total_dropped
            if self.online is not None:
                # flush unmatched entries exactly like the offline fold's
                # finish(), and scale when the estimator semantics are exact
                scale = self.cfg.sampling_interval if self._modes_used == ["sampled"] else 1
                self.final_tally = self.online.finish(scale=scale)
            agg_path = None
            if self.cfg.aggregate_only:
                agg_path = self._write_aggregate_and_prune()
            elif (
                "tally-only" in self._modes_used
                and not self._writers
                and self.final_tally is not None
            ):
                # a session that never streamed still leaves its kilobyte
                # aggregate behind (§3.7 shape, producer-side fold)
                from .aggregate import save_tally

                agg_path = self._aggregate_path()
                save_tally(self.final_tally, agg_path)
            # upstream delivery counters live on the leaf streamer, or on the
            # in-process master's forwarder when this rank is a local master
            pusher = self.streamer
            if pusher is None and self.server is not None:
                pusher = self.server.forwarder
            self.handle = TraceHandle(
                trace_dir=self.cfg.out_dir,
                mode=self.cfg.mode,
                events=events,
                dropped=dropped,
                size_bytes=trace_size_bytes(self.cfg.out_dir),
                aggregate_path=agg_path,
                streamed=pusher.pushed if pusher else 0,
                stream_dropped=pusher.dropped if pusher else 0,
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
        """Drain every ring zero-copy: stream + online analysis read the ring
        storage through ``drain_view`` memoryviews and the region is released
        only after both consumed it.  A ring that has produced nothing (an
        idle thread) gets no ``StreamWriter`` — and so no empty
        ``stream_*.ctf`` file — until its first record or drop shows up; the
        ``now()`` stamp for discard records is only taken when the drop
        counter advanced.

        On the "tally-only" fidelity rung the stream path is bypassed
        entirely — records fold straight into the online analyzer and no
        ``.ctf`` file is created or appended; ring drops are accounted into
        the online tally instead of a stream discard record.  Caller holds
        ``_drain_lock`` (drains serialize against mid-run rung flips)."""
        assert self.registry is not None
        writers = self._writers
        online = self.online
        tally_only = self._fidelity == "tally-only"
        for ring in self.registry.rings():
            regions = ring.drain_view()
            dropped = ring.dropped
            key = (ring.pid, ring.tid)
            if tally_only:
                if regions:
                    chunk = regions[0] if len(regions) == 1 else b"".join(regions)
                    online.feed(chunk, ring.pid, ring.tid)
                    ring.release()
                seen = self._seen_drops.get(key)
                if seen is None:
                    w = writers.get(key)
                    seen = w.seen_dropped if w is not None else 0
                if dropped != seen:
                    online.note_discarded(dropped - seen)
                    self._seen_drops[key] = dropped
                continue
            w = writers.get(key)
            if w is None:
                if not regions and not dropped:
                    continue  # idle thread: defer stream-file creation
                path = os.path.join(self.cfg.out_dir, f"stream_{ring.pid}_{ring.tid}.ctf")
                w = writers[key] = StreamWriter(
                    path, ring.pid, ring.tid, compress=self.cfg.compress
                )
                # drops already accounted to the online tally during a
                # tally-only window must not re-emit as stream discards
                if key in self._seen_drops:
                    w.seen_dropped = self._seen_drops.pop(key)
            elif key in self._seen_drops:
                w.seen_dropped = max(w.seen_dropped, self._seen_drops.pop(key))
            cw = self._colwriters.get(key)
            if cw is None and self.cfg.columnar:
                cw = self._colwriters[key] = self._new_colwriter(w)
            if regions:
                for r in regions:
                    w.append(r)
                if online is not None or cw is not None:
                    # two regions = wrap: records may straddle the boundary,
                    # so the folds get them joined (rare; one copy)
                    chunk = regions[0] if len(regions) == 1 else b"".join(regions)
                    if online is not None:
                        online.feed(chunk, ring.pid, ring.tid)
                    if cw is not None:
                        cw.append(chunk)
                ring.release()
            if dropped != w.seen_dropped:
                delta = dropped - w.seen_dropped
                w.note_drops(dropped, now())
                if cw is not None and delta > 0:
                    # discard records go straight to the stream file; the
                    # sidecar's footer tally must account them too
                    cw.note_discard(delta)

    def _new_colwriter(self, w: StreamWriter):
        from .ctf import ColumnarWriter, sidecar_path

        if self._fold_engine is None:
            from .fold import FoldEngine

            self._fold_engine = FoldEngine(self.model)
        return ColumnarWriter(self._fold_engine, w.pid, w.tid, sidecar_path(w.path))

    def _consumer_loop(self) -> None:
        while not self._stop_evt.wait(self.cfg.flush_period_s):
            self._drain_once()
            self._stream_tick()
            if self.adaptive is not None:
                self.adaptive.tick()
            if self.cluster is not None:
                self.cluster.tick()

    def _stream_tick(self, final: bool = False) -> None:
        """Push the live tally to the streaming service (§3.7+§6).

        One snapshot feeds both targets: the in-process master (when this
        rank serves) and the upstream master (when this rank is a leaf).
        The final push at stop() is unconditional — it carries the
        authoritative cumulative tally the composite converges on.
        """
        if self.online is None or (self.streamer is None and self.server is None):
            return
        t = time.monotonic()
        if not final and t < self._stream_next:
            return
        self._stream_next = t + self.cfg.stream_period_s
        snap = self.online.snapshot()
        if final and self._modes_used == ["sampled"] and self.cfg.sampling_interval > 1:
            # the authoritative last push carries the same 1/N estimate the
            # offline fold (and finish()) produce for a pure-sampled session,
            # so the live composite converges on the on-disk aggregate
            snap.scale(self.cfg.sampling_interval)
        telem = self._telemetry_snapshot() if self.cfg.stream_telemetry else None
        if self.server is not None:
            self.server.submit(
                self._stream_source,
                snap,
                telemetry=telem,
                incarnation=self.cfg.stream_incarnation,
            )
        if self.streamer is not None:
            self.streamer.push(snap, telemetry=telem)

    def _telemetry_snapshot(self) -> Optional[dict]:
        """This rank's device-telemetry dict for the outgoing frame: on the
        card, the caching allocator's bytes in use and peak and the card's
        capacity (``telemetry.read_device_memory``).

        With the sampling daemon on, reuse its latest sample (one reader of
        the shared gauges).  Before its first sample (a session shorter than
        one sample period) send the memory figures and host RSS read inline
        and leave the gauges to the daemon.  Without it, take a cheap inline
        reading — the gauges' only reader is then this tick, so
        read-and-reset is safe.
        """
        if self._sampler is not None:
            last = self._sampler.last
            if last:
                return dict(last)
            in_use, peak, limit = _telemetry.read_device_memory()
            return {
                "mem_in_use": in_use,
                "mem_peak": peak,
                "mem_limit": limit,
                "host_rss": _telemetry.read_host_rss(),
            }
        in_use, peak, limit = _telemetry.read_device_memory()
        memcpy_bw, alloc_bw = _telemetry.TransferGauge.read_and_reset()
        return {
            "mem_in_use": in_use,
            "mem_peak": peak,
            "mem_limit": limit,
            "host_rss": _telemetry.read_host_rss(),
            "step_rate": _telemetry.StepRateGauge.read_and_reset(),
            "memcpy_bw": memcpy_bw,
            "alloc_bw": alloc_bw,
        }

    # -- §3.7 aggregate-only ---------------------------------------------------
    def _aggregate_path(self) -> str:
        return os.path.join(self.cfg.out_dir, f"aggregate_rank{self.cfg.rank}.tally")

    def _write_aggregate_and_prune(self) -> str:
        # Imported here: analysis layer depends on tracer, not vice versa.
        from .aggregate import save_tally
        from .plugins.tally import tally_trace

        path = self._aggregate_path()
        save_tally(tally_trace(self.cfg.out_dir), path)
        for name in os.listdir(self.cfg.out_dir):
            if name.endswith((".ctf", ".ctfcol")):
                os.unlink(os.path.join(self.cfg.out_dir, name))
        return path


def trace_session(out_dir: str, mode: str = "default", **kw) -> Tracer:
    """Convenience constructor mirroring ``iprof -m <mode> --sample``."""
    return Tracer(TraceConfig(out_dir=out_dir, mode=mode, **kw))
