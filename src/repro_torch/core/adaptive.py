"""Adaptive-optimization consumer (THAPI §6, the paper's closing vision).

    "we are also working on online trace analysis, where tracing and analysis
     can be performed concurrently to enable adaptive optimizations during
     application runtime."

``online.py`` gives a rank a *live tally*; ``stream.py`` gives the cluster a
*live composite* — and, since protocol v2.1, a live **per-rank breakdown**.
This module closes the loop at both scopes:

  * an :class:`AdaptiveController` rides the tracer's consumer thread,
    computes **windowed** rates from successive live snapshots of *this
    rank* (busy fraction, per-call latency, ring-buffer drops), and hands
    them to pluggable :class:`AdaptivePolicy` objects that may turn session
    knobs *mid-run* — widen event sampling, resize ring buffers for new
    threads, retune snapshot cadence;
  * a :class:`ClusterAdaptiveController` reads the per-rank tally map of a
    streaming master (in-process via ``MasterServer.ranks()`` or remote via
    ``query_ranks``), diffs consecutive per-rank snapshots into cross-rank
    windowed metrics (per-rank busy fraction / latency, rank-vs-median skew
    ratios), and hands them to :class:`ClusterPolicy` objects —
    :class:`StragglerRankPolicy` flags lagging ranks and feeds API-level
    evidence (which rank, which API, how far behind) into the trainer's
    straggler watchdog; :class:`RankImbalanceAdvisoryPolicy` narrates load
    skew.  The signals these policies act on only exist *across* ranks: a
    straggler looks healthy in its own tally and only lags relative to the
    cluster median.

Wiring:

  * ``TraceConfig(adaptive=[...policies...])`` — the tracer builds a
    controller and ticks it from the consumer loop every
    ``adaptive_period_s`` (collection hot paths never see it);
  * ``TraceConfig(cluster_adaptive=[...], serve_port=...)`` — the tracer
    binds a cluster controller to its in-process master and ticks it from
    the same consumer loop every ``cluster_period_s``;
  * ``ServeEngine(..., adaptive=…, cluster_adaptive=…)`` — the serving loop
    ticks the same machinery between decode steps, with ``ctx.engine`` set
    so policies can reach serving knobs;
  * every knob change is recorded as an :class:`AdaptiveAction` (see
    ``controller.actions``) *and* traced as an advisory event, so the
    reconfiguration itself is visible post-mortem.

This is the port's own copy of the JAX package's adaptive module, with the
same names; on the card the engine ticks it between CUDA-graph replays of the
decode step.

Windowed metrics, not cumulative ones: ``OnlineAnalyzer.busy_fraction`` is
share-of-total since session start; a policy reacting mid-run needs the
share over the *last* window, so the controllers diff consecutive snapshots.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .plugins.tally import Tally


@dataclasses.dataclass
class AdaptiveAction:
    """One knob change (or advisory) taken by a policy, for the audit log."""

    ts: float  # wall clock
    policy: str
    knob: str
    value: str
    reason: str

    def __str__(self) -> str:
        return f"[adaptive] {self.policy}: {self.knob}={self.value} ({self.reason})"


class AdaptiveContext:
    """What a policy sees on one tick: windowed live metrics + session knobs.

    Metrics are computed from the difference between the previous tick's
    tally snapshot and the current one over ``window_s`` of wall time, so
    they describe *recent* behavior.  Knob setters go through the
    controller, which records an :class:`AdaptiveAction` and emits an
    advisory event into the trace.
    """

    def __init__(
        self,
        controller: "AdaptiveController",
        prev: Tally,
        cur: Tally,
        window_s: float,
        engine=None,
    ):
        self._controller = controller
        self._prev = prev
        self._cur = cur
        self.window_s = window_s
        #: the ServeEngine driving this tick, when ticked from the serving
        #: loop (None on consumer-thread ticks)
        self.engine = engine
        self._policy = "?"  # set by the controller per policy

    # -- windowed metrics ----------------------------------------------------
    def _window(self, provider: str, api: str, device: bool) -> Tuple[int, int]:
        """(calls, total_ns) accumulated inside the last window."""
        cur_t = self._cur.device_apis if device else self._cur.apis
        prev_t = self._prev.device_apis if device else self._prev.apis
        c = cur_t.get((provider, api))
        if c is None:
            return 0, 0
        p = prev_t.get((provider, api))
        if p is None:
            return c.calls, c.total_ns
        return c.calls - p.calls, c.total_ns - p.total_ns

    def busy_fraction(self, provider: str, api: str, device: bool = False) -> float:
        """Share of the last window's wall time spent inside ``api``."""
        if self.window_s <= 0:
            return 0.0
        _, total_ns = self._window(provider, api, device)
        return total_ns / (self.window_s * 1e9)

    def window_calls(self, provider: str, api: str, device: bool = False) -> int:
        """Calls to ``api`` completed during the last window."""
        calls, _ = self._window(provider, api, device)
        return calls

    def window_latency_ns(self, provider: str, api: str, device: bool = False) -> float:
        """Mean per-call latency of ``api`` over the last window (0 if idle)."""
        calls, total_ns = self._window(provider, api, device)
        return total_ns / calls if calls > 0 else 0.0

    def dropped_in_window(self) -> int:
        """Ring-buffer events discarded during the last window."""
        return self._controller._window_dropped

    def snapshot(self) -> Tally:
        """The current cumulative live tally (for policies that need it)."""
        return self._cur

    # -- knobs ---------------------------------------------------------------
    def set_stream_period(self, seconds: float, reason: str = "") -> None:
        """Retune the live-snapshot push cadence (``stream_period_s``)."""
        tr = self._controller._tracer
        if tr is None:
            return
        tr.cfg.stream_period_s = max(0.01, float(seconds))
        self._act("stream_period_s", f"{tr.cfg.stream_period_s:g}", reason)

    def set_flush_period(self, seconds: float, reason: str = "") -> None:
        """Retune the consumer drain period (``flush_period_s``)."""
        tr = self._controller._tracer
        if tr is None:
            return
        tr.cfg.flush_period_s = max(0.005, float(seconds))
        self._act("flush_period_s", f"{tr.cfg.flush_period_s:g}", reason)

    def set_sample_period(self, seconds: float, reason: str = "") -> None:
        """Retune the telemetry daemon's sampling period, when it runs."""
        tr = self._controller._tracer
        sampler = getattr(tr, "_sampler", None) if tr is not None else None
        if sampler is None:
            return
        sampler.period_s = max(0.005, float(seconds))
        self._act("sample_period_s", f"{sampler.period_s:g}", reason)

    def set_event(self, name: str, on: bool, reason: str = "") -> None:
        """Enable/disable one tracepoint live (widen or narrow sampling)."""
        tr = self._controller._tracer
        if tr is None:
            return
        tr.tp.set_event(name, on)
        self._act(f"event:{name}", "on" if on else "off", reason)

    def set_ring_bytes(self, nbytes: int, reason: str = "") -> None:
        """Resize the ring-buffer capacity used for *future* threads."""
        tr = self._controller._tracer
        if tr is None or tr.registry is None:
            return
        tr.registry.set_capacity(int(nbytes))
        self._act("ring_bytes", str(int(nbytes)), reason)

    def set_mode(self, mode: str, reason: str = "") -> None:
        """Move the session along the fidelity ladder mid-run
        (``"full" | "sampled" | "tally-only" | "off"``) — the
        escalate-on-trouble lever.  No-op when already on that rung."""
        tr = self._controller._tracer
        if tr is None:
            return
        prev = tr.set_mode(mode)
        if prev != mode:
            self._act("fidelity", mode, reason)

    @property
    def mode(self) -> str:
        """Current fidelity rung of the attached session ("full" unbound)."""
        tr = self._controller._tracer
        return tr.fidelity if tr is not None else "full"

    def advise(self, knob: str, value: str, reason: str = "") -> None:
        """Record an advisory-only action (no knob turned): it lands in the
        controller log and as an ``ust_repro:advisory`` trace event."""
        self._act(knob, value, reason)

    def _act(self, knob: str, value: str, reason: str) -> None:
        self._controller._record(self._policy, knob, value, reason)


class AdaptivePolicy:
    """Base class: look at an :class:`AdaptiveContext`, optionally turn knobs.

    Policies are stateful objects, invoked once per controller tick on the
    consumer (or serving) thread; they must be fast and must never raise —
    the controller isolates exceptions, but a throwing policy stops
    adapting.  ``name`` labels the policy in action logs and advisory
    events.
    """

    name = "policy"

    def tick(self, ctx: AdaptiveContext) -> None:
        raise NotImplementedError


class WidenSamplingPolicy(AdaptivePolicy):
    """Widen tally sampling when one API dominates the window.

    While ``busy_fraction(provider, api)`` stays above ``high``, the events
    in ``widen_events`` (typically polling / telemetry events excluded by
    the mode preset) are enabled to capture *why* the API is hot; once the
    fraction falls below ``low`` they are disabled again — Fig 7's overhead
    ladder applied dynamically instead of picked up front.
    """

    name = "widen-sampling"

    def __init__(
        self,
        provider: str,
        api: str,
        widen_events: Sequence[str],
        high: float = 0.5,
        low: float = 0.1,
    ):
        self.provider = provider
        self.api = api
        self.widen_events = tuple(widen_events)
        self.high = high
        self.low = low
        self.widened = False

    def tick(self, ctx: AdaptiveContext) -> None:
        busy = ctx.busy_fraction(self.provider, self.api)
        if not self.widened and busy >= self.high:
            self.widened = True
            for name in self.widen_events:
                ctx.set_event(
                    name, True, f"busy_fraction({self.api})={busy:.2f}≥{self.high}"
                )
        elif self.widened and busy <= self.low:
            self.widened = False
            for name in self.widen_events:
                ctx.set_event(
                    name, False, f"busy_fraction({self.api})={busy:.2f}≤{self.low}"
                )


class StreamCadencePolicy(AdaptivePolicy):
    """Snapshot faster while a watched API is hot, slower while idle.

    A live dashboard wants fresh composites exactly when something is
    happening; when the window is quiet, pushing snapshots is pure wire
    noise.  Moves ``stream_period_s`` between ``fast_s`` and ``slow_s`` on
    the ``high`` / ``low`` busy-fraction thresholds.
    """

    name = "stream-cadence"

    def __init__(
        self,
        provider: str,
        api: str,
        high: float = 0.3,
        low: float = 0.05,
        fast_s: float = 0.1,
        slow_s: float = 1.0,
    ):
        self.provider = provider
        self.api = api
        self.high = high
        self.low = low
        self.fast_s = fast_s
        self.slow_s = slow_s
        self._state = ""  # "", "fast", "slow"

    def tick(self, ctx: AdaptiveContext) -> None:
        busy = ctx.busy_fraction(self.provider, self.api)
        if busy >= self.high and self._state != "fast":
            self._state = "fast"
            ctx.set_stream_period(
                self.fast_s, f"busy_fraction({self.api})={busy:.2f}≥{self.high}"
            )
        elif busy <= self.low and self._state != "slow":
            self._state = "slow"
            ctx.set_stream_period(
                self.slow_s, f"busy_fraction({self.api})={busy:.2f}≤{self.low}"
            )


class RingPressurePolicy(AdaptivePolicy):
    """Grow ring-buffer capacity when the window shows discarded events.

    Rings drop rather than block (§3.1); sustained drops mean the configured
    capacity undershoots the event rate.  Each tick that observes new drops
    doubles the capacity used for future threads' rings (bounded by
    ``max_bytes``) and emits an advisory either way, so the drop burst is
    visible in the trace even when the cap is reached.
    """

    name = "ring-pressure"

    def __init__(self, factor: float = 2.0, max_bytes: int = 1 << 26):
        self.factor = factor
        self.max_bytes = max_bytes

    def tick(self, ctx: AdaptiveContext) -> None:
        dropped = ctx.dropped_in_window()
        if dropped <= 0:
            return
        tr = ctx._controller._tracer
        if tr is None or tr.registry is None:
            return
        cur = tr.registry.capacity
        if cur >= self.max_bytes:
            ctx.advise("ring_bytes", str(cur), f"{dropped} drops but cap reached")
            return
        ctx.set_ring_bytes(
            min(self.max_bytes, int(cur * self.factor)),
            f"{dropped} events dropped in window",
        )


class EscalateFidelity(AdaptivePolicy):
    """Walk the fidelity ladder on evidence: cheap by default, full on trouble.

    The run sits at ``floor`` (default ``tally-only`` — counts but no stream
    files).  Each window that shows trouble — the watched API's mean latency
    at or above ``latency_high_ns``, or (``on_drops``) ring-buffer discards —
    climbs one rung toward ``ceiling``; ``healthy_windows`` consecutive calm
    windows step one rung back down toward ``floor``.  Every transition goes
    through the torn-free :meth:`~repro_torch.core.tracer.Tracer.set_mode` handoff
    and is logged as an ``AdaptiveAction`` + advisory event, so the trace
    records *when* and *why* its own fidelity changed.

    ``floor`` should stay at ``tally-only`` or higher: on the ``off`` rung
    nothing is recorded, so no evidence can ever trigger re-escalation
    (drops excepted — rings are idle too, so there are none).
    """

    name = "escalate-fidelity"

    #: rung order, cheapest first
    LADDER = ("off", "tally-only", "sampled", "full")

    def __init__(
        self,
        provider: str,
        api: str,
        latency_high_ns: float,
        floor: str = "tally-only",
        ceiling: str = "full",
        healthy_windows: int = 3,
        on_drops: bool = True,
        device: bool = False,
    ):
        if floor not in self.LADDER or ceiling not in self.LADDER:
            raise ValueError(f"floor/ceiling must be one of {self.LADDER}")
        if self.LADDER.index(floor) > self.LADDER.index(ceiling):
            raise ValueError(f"floor {floor!r} above ceiling {ceiling!r}")
        self.provider = provider
        self.api = api
        self.latency_high_ns = latency_high_ns
        self.floor = floor
        self.ceiling = ceiling
        self.healthy_windows = max(1, int(healthy_windows))
        self.on_drops = on_drops
        self.device = device
        self._calm = 0

    def _step(self, mode: str, up: bool) -> str:
        i = self.LADDER.index(mode) + (1 if up else -1)
        i = min(max(i, self.LADDER.index(self.floor)), self.LADDER.index(self.ceiling))
        return self.LADDER[i]

    def tick(self, ctx: AdaptiveContext) -> None:
        lat = ctx.window_latency_ns(self.provider, self.api, self.device)
        dropped = ctx.dropped_in_window() if self.on_drops else 0
        trouble = lat >= self.latency_high_ns or dropped > 0
        cur = ctx.mode
        if cur not in self.LADDER:
            return
        if trouble:
            self._calm = 0
            nxt = self._step(cur, up=True)
            if nxt != cur:
                why = (
                    f"{self.provider}:{self.api} latency {lat:.0f}ns≥{self.latency_high_ns:.0f}ns"
                    if lat >= self.latency_high_ns
                    else f"{dropped} events dropped in window"
                )
                ctx.set_mode(nxt, why)
        else:
            self._calm += 1
            if self._calm >= self.healthy_windows:
                nxt = self._step(cur, up=False)
                if nxt != cur:
                    self._calm = 0
                    ctx.set_mode(
                        nxt, f"{self.healthy_windows} healthy windows, stepping down"
                    )


class ThresholdAdvisoryPolicy(AdaptivePolicy):
    """Emit an advisory whenever a busy fraction crosses a threshold.

    The no-knob policy: it only narrates.  Useful to mark phases in the
    trace ("train_step saturated from t₁ to t₂") or as the template for
    application-defined reactions — subclass and override :meth:`react`.
    """

    name = "threshold-advisory"

    def __init__(self, provider: str, api: str, high: float = 0.5, low: float = 0.1):
        self.provider = provider
        self.api = api
        self.high = high
        self.low = low
        self.above = False

    def react(self, ctx: AdaptiveContext, above: bool, busy: float) -> None:
        ctx.advise(
            f"busy:{self.provider}:{self.api}",
            "high" if above else "low",
            f"busy_fraction={busy:.2f}",
        )

    def tick(self, ctx: AdaptiveContext) -> None:
        busy = ctx.busy_fraction(self.provider, self.api)
        if not self.above and busy >= self.high:
            self.above = True
            self.react(ctx, True, busy)
        elif self.above and busy <= self.low:
            self.above = False
            self.react(ctx, False, busy)


class _ControllerCore:
    """Shared machinery of the per-rank and cluster-scope controllers:
    the append-only action log, the ``on_action`` observer, and the
    ``ust_repro:advisory`` trace-event plumbing."""

    def __init__(
        self,
        period_s: float,
        on_action: Optional[Callable[[AdaptiveAction], None]] = None,
    ):
        self.period_s = period_s
        self.on_action = on_action
        self.actions: List[AdaptiveAction] = []
        self.ticks = 0
        self._tracer = None
        self._advise_record = None  # ust_repro:advisory recorder, when traced
        self._lock = threading.Lock()

    def attach(self, tracer) -> "_ControllerCore":
        """Bind to a live tracing session: advisories land in its trace."""
        self._tracer = tracer
        rec = getattr(tracer, "tp", None)
        self._advise_record = rec.record.get("ust_repro:advisory") if rec else None
        return self

    def _record(self, policy: str, knob: str, value: str, reason: str) -> None:
        act = AdaptiveAction(time.time(), policy, knob, value, reason)
        self.actions.append(act)
        if self._advise_record is not None:
            try:
                self._advise_record(policy, knob, f"{value} ({reason})")
            except Exception:
                pass  # advisory must never break adaptation
        if self.on_action is not None:
            self.on_action(act)

    def render_log(self) -> str:
        """Human-readable action log (one line per action)."""
        return "\n".join(str(a) for a in self.actions)


class AdaptiveController(_ControllerCore):
    """Owns the policies; diffs live snapshots; rate-limits ticks.

    Built by the tracer from ``TraceConfig.adaptive`` (or handed to a
    :class:`ServeEngine`); both call :meth:`tick` from their loops and the
    controller decides (every ``period_s``) whether a window has elapsed.
    Thread-safe: consumer-thread and serving-thread ticks may interleave.

    ``actions`` is the append-only audit log; ``on_action`` (optional
    callable) observes every action as it happens — handy for tests and
    for surfacing adaptations in training logs.
    """

    def __init__(
        self,
        policies: Sequence[AdaptivePolicy],
        period_s: float = 0.5,
        on_action: Optional[Callable[[AdaptiveAction], None]] = None,
    ):
        super().__init__(period_s, on_action)
        self.policies = list(policies)
        self._prev_snap: Optional[Tally] = None
        self._prev_t = 0.0
        self._prev_dropped = 0
        self._window_dropped = 0

    def attach(self, tracer) -> "AdaptiveController":
        """Bind to a live tracing session (the tracer calls this at start)."""
        super().attach(tracer)
        with self._lock:
            self._prev_snap = None
            self._prev_t = 0.0
            self._prev_dropped = 0
        return self

    def tick(self, engine=None, force: bool = False) -> bool:
        """Run one adaptation window if due; True when policies actually ran.

        The first due tick only baselines (no policy sees a window computed
        against an empty history). Policy exceptions are swallowed per
        policy, so one misbehaving policy cannot stop the others — or the
        consumer thread.

        An unattached controller (e.g. a ``ServeEngine`` built before its
        ``Tracer`` started) attaches itself to the process's active session
        on first tick, so construction order doesn't matter.
        """
        if self._tracer is None:
            from .tracer import active_tracer

            tr = active_tracer()
            if tr is not None:
                self.attach(tr)
        tr = self._tracer
        if tr is None or tr.online is None:
            return False
        with self._lock:
            now = time.monotonic()
            if not force and self._prev_snap is not None and (
                now - self._prev_t < self.period_s
            ):
                return False
            cur = tr.online.snapshot()
            dropped_total = tr.registry.total_dropped if tr.registry is not None else 0
            prev, prev_t = self._prev_snap, self._prev_t
            self._window_dropped = dropped_total - self._prev_dropped
            self._prev_snap, self._prev_t = cur, now
            self._prev_dropped = dropped_total
            if prev is None:
                return False  # baseline window
            self.ticks += 1
            ctx = AdaptiveContext(self, prev, cur, max(1e-9, now - prev_t), engine)
            for pol in self.policies:
                ctx._policy = pol.name
                try:
                    pol.tick(ctx)
                except Exception:
                    pass  # a policy must never kill the consumer thread
            return True


# ---------------------------------------------------------------------------
# Cluster scope: per-rank composites → cross-rank policies
# ---------------------------------------------------------------------------


class ClusterContext:
    """What a cluster policy sees on one tick: per-rank windowed metrics.

    Built from two consecutive per-rank tally maps (source id → cumulative
    tally, the ``query_ranks`` / ``MasterServer.ranks`` shape) ``window_s``
    apart, so every metric describes *recent, per-rank* behavior.  The
    cross-rank views (``latency_by_rank``, ``busy_by_rank``,
    ``skew_by_rank``) are where cluster-only signals appear: a straggling
    rank looks normal in its own window and only stands out against the
    cluster median.
    """

    def __init__(
        self,
        controller: "ClusterAdaptiveController",
        prev: Dict[str, Tally],
        cur: Dict[str, Tally],
        window_s: float,
        telemetry: Optional[Dict[str, dict]] = None,
    ):
        self._controller = controller
        self._prev = prev
        self._cur = cur
        self.window_s = window_s
        self._telemetry = telemetry or {}
        self._policy = "?"  # set by the controller per policy
        #: sources flagged (any kind) during this tick — the controller
        #: reports every other active source healthy afterwards (hysteresis
        #: channel of the remediation engine)
        self.flagged_sources: set = set()

    # -- per-rank windowed metrics -------------------------------------------
    def rank_ids(self) -> List[str]:
        """Sorted source ids present in the current per-rank map."""
        return sorted(self._cur)

    def window(
        self, source: str, provider: str, api: str, device: bool = False
    ) -> Tuple[int, int]:
        """(calls, total_ns) ``source`` accumulated inside the last window.

        A source absent from the *previous* map is newly joined (elastic
        scale-up, late rank): its whole cumulative history — jit compiles
        included — is not a window, so it baselines as (0, 0) and starts
        contributing from the next observation, exactly like the
        controller's own first tick.  An API absent from the previous map
        of a *known* source genuinely appeared this window and counts in
        full.
        """
        cur_tally = self._cur.get(source)
        prev_tally = self._prev.get(source)
        if cur_tally is None or prev_tally is None:
            return 0, 0
        cur_t = cur_tally.device_apis if device else cur_tally.apis
        c = cur_t.get((provider, api))
        if c is None:
            return 0, 0
        prev_t = prev_tally.device_apis if device else prev_tally.apis
        p = prev_t.get((provider, api))
        if p is None:
            return c.calls, c.total_ns
        return c.calls - p.calls, c.total_ns - p.total_ns

    def busy_fraction(
        self, source: str, provider: str, api: str, device: bool = False
    ) -> float:
        """Share of the last window's wall time ``source`` spent in ``api``."""
        if self.window_s <= 0:
            return 0.0
        _, total_ns = self.window(source, provider, api, device)
        return total_ns / (self.window_s * 1e9)

    def latency_ns(
        self, source: str, provider: str, api: str, device: bool = False
    ) -> float:
        """``source``'s mean per-call latency of ``api`` over the window."""
        calls, total_ns = self.window(source, provider, api, device)
        return total_ns / calls if calls > 0 else 0.0

    def snapshot(self, source: str) -> Optional[Tally]:
        """``source``'s current cumulative tally (None if unknown)."""
        return self._cur.get(source)

    def telemetry(self, source: str) -> Optional[dict]:
        """``source``'s latest device-telemetry dict (host RSS, device
        memory pressure, memcpy/alloc bandwidth — docs/streaming.md), or
        None when its frames never carried any."""
        return self._telemetry.get(source)

    def telemetry_by_rank(self) -> Dict[str, dict]:
        """source → its latest telemetry dict (sources that shipped one)."""
        return dict(self._telemetry)

    # -- cross-rank views ----------------------------------------------------
    def busy_by_rank(
        self, provider: str, api: str, device: bool = False
    ) -> Dict[str, float]:
        """source → windowed busy fraction, ranks active this window only."""
        out = {}
        for src in self._cur:
            calls, _ = self.window(src, provider, api, device)
            if calls > 0:
                out[src] = self.busy_fraction(src, provider, api, device)
        return out

    def latency_by_rank(
        self, provider: str, api: str, device: bool = False, min_calls: int = 1
    ) -> Dict[str, float]:
        """source → windowed mean latency, ranks with ≥ ``min_calls`` only."""
        out = {}
        for src in self._cur:
            calls, total_ns = self.window(src, provider, api, device)
            if calls >= max(1, min_calls):
                out[src] = total_ns / calls
        return out

    def skew_by_rank(
        self, provider: str, api: str, metric: str = "latency", device: bool = False
    ) -> Dict[str, float]:
        """source → ratio of its windowed metric to the cluster median.

        A healthy, balanced cluster sits near 1.0 everywhere; a straggler
        shows a ratio ≫ 1.  Empty when fewer than two ranks were active (a
        median of one rank compares it to itself).
        """
        vals = (
            self.latency_by_rank(provider, api, device)
            if metric == "latency"
            else self.busy_by_rank(provider, api, device)
        )
        if len(vals) < 2:
            return {}
        med = statistics.median(vals.values())
        if med <= 0:
            return {}
        return {src: v / med for src, v in vals.items()}

    # -- actions -------------------------------------------------------------
    def advise(self, knob: str, value: str, reason: str = "") -> None:
        """Record an advisory action: controller log + trace event (when a
        session is attached)."""
        self._controller._record(self._policy, knob, value, reason)

    def flag_straggler(
        self, source: str, provider: str, api: str, ratio: float, reason: str = ""
    ) -> None:
        """Report ``source`` as a straggler: advisory + workload callback.

        This is the API-level evidence channel into the trainer — the
        controller's ``on_straggler`` callback (e.g.
        ``StragglerWatchdog.note_api_evidence``) receives *which rank*,
        *which API*, and *how far behind the median*.
        """
        self.advise(f"straggler:{source}", f"{provider}:{api}={ratio:.2f}x", reason)
        self.flagged_sources.add(source)
        self._controller._notify_straggler(source, provider, api, ratio, reason)
        self._controller._notify_flag(source, "straggler", f"{provider}:{api} {reason}")

    def flag(self, source: str, kind: str, detail: str = "") -> None:
        """Report ``source`` unhealthy for any ``kind`` of evidence
        (``"sick-host"``, ``"imbalance"``, ...): advisory + the controller's
        generic ``on_flag`` callback — the channel the remediation engine's
        escalation ladder consumes."""
        self.advise(f"{kind}:{source}", "flagged", detail)
        self.flagged_sources.add(source)
        self._controller._notify_flag(source, kind, detail)


class ClusterPolicy:
    """Base class for cluster-scope policies: look at a
    :class:`ClusterContext`, optionally advise or flag ranks.

    Same contract as :class:`AdaptivePolicy`: stateful, invoked once per
    controller tick, must be fast, exceptions are isolated per policy.
    """

    name = "cluster-policy"

    def tick(self, ctx: ClusterContext) -> None:
        raise NotImplementedError


class StragglerRankPolicy(ClusterPolicy):
    """Flag ranks whose windowed metric lags the cluster median.

    The cluster-scope answer to the trainer's wall-clock EWMA watchdog: the
    EWMA knows *this* rank had slow steps; this policy knows *which* rank is
    slow relative to the others, on *which* API, and by *how much* — the
    evidence exascale diagnostics actually need for rank replacement.

    Per tick: compute the per-rank windowed metric (``latency`` — mean ns
    per call of the watched API — or ``busy`` fraction), take the cluster
    median, and strike every rank at ≥ ``ratio`` × median.  A rank flagged
    ``patience`` consecutive windows is reported once via
    ``ctx.flag_straggler`` (advisory + ``on_straggler`` callback) and
    re-armed when it drops back below the threshold (a ``recovered``
    advisory marks the transition).
    """

    name = "straggler-rank"

    def __init__(
        self,
        provider: str,
        api: str,
        ratio: float = 1.75,
        metric: str = "latency",
        patience: int = 2,
        min_ranks: int = 2,
        min_calls: int = 1,
        device: bool = False,
    ):
        if metric not in ("latency", "busy"):
            raise ValueError(f"metric must be 'latency' or 'busy', got {metric!r}")
        self.provider = provider
        self.api = api
        self.ratio = ratio
        self.metric = metric
        self.patience = max(1, int(patience))
        self.min_ranks = max(2, int(min_ranks))
        self.min_calls = max(1, int(min_calls))
        self.device = device
        self._strikes: Dict[str, int] = {}
        #: currently-flagged ranks → last observed ratio
        self.flagged: Dict[str, float] = {}

    def tick(self, ctx: ClusterContext) -> None:
        vals = (
            ctx.latency_by_rank(
                self.provider, self.api, self.device, min_calls=self.min_calls
            )
            if self.metric == "latency"
            else ctx.busy_by_rank(self.provider, self.api, self.device)
        )
        if len(vals) < self.min_ranks:
            # no comparative window: nothing can be struck, so nothing may
            # stay struck — "patience consecutive windows" means consecutive.
            # Flags drop too: an idle/quorumless stretch ends the excursion,
            # and fresh evidence must be able to re-report the rank.
            self._strikes.clear()
            self.flagged.clear()
            return
        med = statistics.median(vals.values())
        if med <= 0:
            self._strikes.clear()
            self.flagged.clear()
            return
        for src in list(self._strikes):
            if src not in vals:  # idle this window: the streak is broken
                del self._strikes[src]
        for src in list(self.flagged):
            if src not in vals:  # idle flagged rank: excursion over, re-arm
                del self.flagged[src]
        for src, v in vals.items():
            r = v / med
            if r >= self.ratio:
                self._strikes[src] = self._strikes.get(src, 0) + 1
                if self._strikes[src] >= self.patience and src not in self.flagged:
                    self.flagged[src] = r
                    ctx.flag_straggler(
                        src,
                        self.provider,
                        self.api,
                        r,
                        f"window {self.metric} {r:.2f}x cluster median "
                        f"({self._strikes[src]} consecutive windows, "
                        f"{len(vals)} ranks)",
                    )
            else:
                self._strikes[src] = 0
                if src in self.flagged:
                    del self.flagged[src]
                    ctx.advise(
                        f"straggler:{src}",
                        "recovered",
                        f"window {self.metric} back to {r:.2f}x median",
                    )


class SickHostPolicy(ClusterPolicy):
    """Flag ranks whose *device telemetry* says the host is sick.

    The straggler policy sees API latency — it cannot tell a slow kernel
    (workload) from a dying host (infrastructure).  This policy reads the
    per-rank telemetry carried in the forwarded breakdown (host RSS, device
    memory pressure, memcpy bandwidth — ``ClusterContext.telemetry``) and
    flags ranks on *host-level* evidence, so the remediation ladder can pick
    the right rung: escalate fidelity on a slow kernel, drain-and-evict a
    sick host.

    Evidence, any of which counts as a strike:

    * device memory pressure: ``mem_in_use / mem_limit ≥ mem_frac``;
    * host RSS blow-up: RSS ≥ ``rss_ratio`` × the cluster median RSS;
    * transfer collapse: the rank's ``memcpy_bw`` ≤ ``bw_floor`` × the
      cluster median while the median is non-trivial (others are moving
      data, this host is not).

    On the card these fields come from ``core/telemetry.py``:
    ``mem_in_use`` is the caching allocator's ``allocated_bytes.all.current``
    (``torch.cuda.memory_stats``), ``mem_limit`` the card's capacity
    (``torch.cuda.get_device_properties``), ``host_rss`` from ``/proc/self/statm``, and
    ``memcpy_bw`` the bytes/s of the traced host-device copies
    (``TransferGauge``).  A CPU rank reports device memory as 0, which never
    strikes.

    ``patience`` consecutive striking windows flag the rank once via
    ``ctx.flag(source, "sick-host", ...)``; dropping back below every
    threshold re-arms it with a ``recovered`` advisory.
    """

    name = "sick-host"

    def __init__(
        self,
        rss_ratio: float = 2.0,
        mem_frac: float = 0.95,
        bw_floor: float = 0.05,
        patience: int = 2,
        min_ranks: int = 2,
    ):
        if not (0.0 < mem_frac <= 1.0):
            raise ValueError(f"mem_frac must be in (0,1], got {mem_frac}")
        self.rss_ratio = rss_ratio
        self.mem_frac = mem_frac
        self.bw_floor = bw_floor
        self.patience = max(1, int(patience))
        self.min_ranks = max(2, int(min_ranks))
        self._strikes: Dict[str, int] = {}
        #: currently-flagged ranks → last evidence string
        self.flagged: Dict[str, str] = {}

    def _evidence(self, telem: dict, med_rss: float, med_bw: float) -> Optional[str]:
        limit = float(telem.get("mem_limit", 0) or 0)
        in_use = float(telem.get("mem_in_use", 0) or 0)
        if limit > 0 and in_use / limit >= self.mem_frac:
            return f"device-memory {100.0 * in_use / limit:.0f}% of limit"
        rss = float(telem.get("host_rss", 0) or 0)
        if med_rss > 0 and rss >= self.rss_ratio * med_rss:
            return f"host-rss {rss / med_rss:.2f}x cluster median"
        bw = float(telem.get("memcpy_bw", 0) or 0)
        if med_bw > 0 and bw <= self.bw_floor * med_bw:
            return f"memcpy-bw {bw:.0f} B/s vs median {med_bw:.0f} B/s"
        return None

    def tick(self, ctx: ClusterContext) -> None:
        telem = ctx.telemetry_by_rank()
        if len(telem) < self.min_ranks:
            self._strikes.clear()
            self.flagged.clear()
            return
        rss_vals = [float(t.get("host_rss", 0) or 0) for t in telem.values()]
        bw_vals = [float(t.get("memcpy_bw", 0) or 0) for t in telem.values()]
        med_rss = statistics.median(rss_vals) if rss_vals else 0.0
        med_bw = statistics.median(bw_vals) if bw_vals else 0.0
        for src in list(self._strikes):
            if src not in telem:  # no telemetry this window: streak broken
                del self._strikes[src]
        for src in list(self.flagged):
            if src not in telem:
                del self.flagged[src]
        for src, t in telem.items():
            ev = self._evidence(t, med_rss, med_bw)
            if ev is not None:
                self._strikes[src] = self._strikes.get(src, 0) + 1
                if self._strikes[src] >= self.patience and src not in self.flagged:
                    self.flagged[src] = ev
                    ctx.flag(
                        src,
                        "sick-host",
                        f"{ev} ({self._strikes[src]} consecutive windows, "
                        f"{len(telem)} ranks)",
                    )
            else:
                self._strikes[src] = 0
                if src in self.flagged:
                    del self.flagged[src]
                    ctx.advise(f"sick-host:{src}", "recovered", "telemetry back in range")


class RankImbalanceAdvisoryPolicy(ClusterPolicy):
    """Narrate cluster-wide load imbalance on a watched API.

    Emits a ``high`` advisory when the max-rank-to-median spread of the
    windowed busy fraction crosses ``high``, and a ``low`` advisory once it
    falls back under ``low`` (hysteresis, like
    :class:`ThresholdAdvisoryPolicy` but across ranks).  No knobs turned —
    the trace simply gains "the cluster ran imbalanced from t₁ to t₂".
    """

    name = "rank-imbalance"

    def __init__(
        self, provider: str, api: str, high: float = 2.0, low: float = 1.25
    ):
        self.provider = provider
        self.api = api
        self.high = high
        self.low = low
        self.above = False

    def tick(self, ctx: ClusterContext) -> None:
        vals = ctx.busy_by_rank(self.provider, self.api)
        if len(vals) < 2:
            return
        med = statistics.median(vals.values())
        if med <= 0:
            return
        spread = max(vals.values()) / med
        knob = f"imbalance:{self.provider}:{self.api}"
        if not self.above and spread >= self.high:
            self.above = True
            ctx.advise(knob, "high", f"max/median busy={spread:.2f} over {len(vals)} ranks")
        elif self.above and spread <= self.low:
            self.above = False
            ctx.advise(knob, "low", f"max/median busy={spread:.2f}")


class ClusterAdaptiveController(_ControllerCore):
    """Owns cluster policies; diffs per-rank maps; rate-limits ticks.

    Reads the per-rank breakdown from a streaming master — in-process
    (``master=MasterServer``, zero-copy via :meth:`MasterServer.ranks`) or
    remote (``addr="host:port"`` via ``query_ranks``) — or from explicit
    :meth:`observe` calls (tests drive synthetic rank maps with an explicit
    clock, no sockets, no sleeps).

    ``on_straggler(source, provider, api, ratio, reason)`` is the workload
    feedback channel: wire ``trainer.straggler_callback`` here and the
    training loop's watchdog receives API-level straggler evidence.
    An unbound controller (no master, no addr) binds itself to the active
    tracing session's in-process master on first tick, mirroring
    :class:`AdaptiveController`'s construction-order independence.
    """

    def __init__(
        self,
        policies: Sequence[ClusterPolicy],
        master=None,
        addr: Optional[str] = None,
        period_s: float = 1.0,
        on_action: Optional[Callable[[AdaptiveAction], None]] = None,
        on_straggler: Optional[Callable[[str, str, str, float, str], None]] = None,
        on_flag: Optional[Callable[[str, str, str], None]] = None,
        on_healthy: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        timeout_s: float = 2.0,
        token: Optional[str] = None,
        tls_ca: Optional[str] = None,
        ssl_context=None,
    ):
        super().__init__(period_s, on_action)
        self.policies = list(policies)
        self.master = master
        self.addr = addr
        self.on_straggler = on_straggler
        #: generic unhealthy-rank channel: ``(source, kind, detail)`` per
        #: flag — wire ``RemediationEngine.ingest_flag`` here to close the
        #: loop.  ``on_healthy(source)`` fires for every active-but-unflagged
        #: source after each adaptation window (the engine's hysteresis).
        self.on_flag = on_flag
        self.on_healthy = on_healthy
        self.clock = clock
        self.timeout_s = timeout_s
        #: credentials for the remote (``addr``) fetch path: hardened
        #: masters demand a token and may sit behind TLS (tls_ca pins them)
        self.token = token
        self.tls_ca = tls_ca
        self.ssl_context = ssl_context
        self._client = None  # persistent StreamClient for the addr path
        self._prev: Optional[Dict[str, Tally]] = None
        self._prev_t = 0.0
        self._attempt_t: Optional[float] = None  # last fetch attempt (any outcome)

    def bind(self, master=None, addr: Optional[str] = None) -> "ClusterAdaptiveController":
        """Point the controller at a master after construction."""
        if master is not None:
            self.master = master
        if addr is not None:
            self.addr = addr
        return self

    def close(self) -> None:
        """Drop the remote connection (the addr path reuses one socket)."""
        c, self._client = self._client, None
        if c is not None:
            c.close()

    def _fetch(self) -> Optional[Tuple[Dict[str, Tally], Dict[str, dict]]]:
        if self.master is not None:
            # frozen snapshots (replaced wholesale on change, never mutated):
            # the windowed diffs only read them, so skip the per-tick deep
            # copy of every rank's table — O(changed) per adaptation window
            return self.master.ranks(copy=False), self.master.telemetry()
        if self.addr is not None:
            from .stream import ProtocolError, StreamClient

            try:
                if self._client is None:
                    self._client = StreamClient(
                        self.addr,
                        timeout_s=self.timeout_s,
                        token=self.token,
                        tls_ca=self.tls_ca,
                        ssl_context=self.ssl_context,
                    )
                ranks, meta = self._client.ranks()
                return ranks, meta.get("telemetry", {})
            except (OSError, ProtocolError, ValueError):
                self.close()  # reconnect fresh on the next attempt
                return None  # master absent: adaptation pauses, never raises
        return None

    def tick(self, force: bool = False) -> bool:
        """Fetch the per-rank map and run one adaptation window if due.

        The rate limit gates *attempts*, not successes: an unreachable
        master (a blocking connect of up to ``timeout_s``) is retried once
        per ``period_s``, never once per caller iteration — a consumer loop
        or decode loop must not stall every pass on a master that is down.
        """
        if self.master is None and self.addr is None:
            from .tracer import active_tracer

            tr = active_tracer()
            if tr is not None and getattr(tr, "server", None) is not None:
                self.master = tr.server
                if self._tracer is None:
                    self.attach(tr)
            else:
                return False
        now = self.clock()
        with self._lock:
            if not force and self._attempt_t is not None and (
                now - self._attempt_t < self.period_s
            ):
                return False
            self._attempt_t = now
        fetched = self._fetch()
        if fetched is None:
            return False
        ranks, telemetry = fetched
        return self.observe(ranks, now, telemetry=telemetry)

    def observe(
        self,
        ranks: Dict[str, Tally],
        now: float,
        telemetry: Optional[Dict[str, dict]] = None,
    ) -> bool:
        """Ingest one per-rank map observed at ``now``; True when policies
        ran.  The first observation only baselines.  Public so tests (and
        alternative transports) can drive the controller with explicit
        clocks and synthetic maps.  ``telemetry`` optionally maps source →
        its device-telemetry dict (the ``meta["telemetry"]`` shape)."""
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = ranks, now
            if prev is None:
                return False  # baseline window
            self.ticks += 1
            ctx = ClusterContext(
                self, prev, ranks, max(1e-9, now - prev_t), telemetry=telemetry
            )
            for pol in self.policies:
                ctx._policy = pol.name
                try:
                    pol.tick(ctx)
                except Exception:
                    pass  # a policy must never kill the consumer thread
            if self.on_healthy is not None:
                # every source seen this window and not flagged by any policy
                # counts as a healthy observation (remediation hysteresis)
                for src in ranks:
                    if src not in ctx.flagged_sources:
                        try:
                            self.on_healthy(src)
                        except Exception:
                            pass  # callback must never break adaptation
            return True

    def _notify_straggler(
        self, source: str, provider: str, api: str, ratio: float, reason: str
    ) -> None:
        if self.on_straggler is not None:
            try:
                self.on_straggler(source, provider, api, ratio, reason)
            except Exception:
                pass  # workload callback must never break adaptation

    def _notify_flag(self, source: str, kind: str, detail: str) -> None:
        if self.on_flag is not None:
            try:
                self.on_flag(source, kind, detail)
            except Exception:
                pass  # workload callback must never break adaptation


def build_cluster_controller(
    policies: Union["ClusterAdaptiveController", Sequence[ClusterPolicy], None],
    period_s: float = 1.0,
    **kw,
) -> Optional[ClusterAdaptiveController]:
    """Normalize ``TraceConfig.cluster_adaptive`` / ``ServeEngine`` input:
    pass through a ready controller, wrap a policy list, map None to None."""
    if policies is None:
        return None
    if isinstance(policies, ClusterAdaptiveController):
        return policies
    return ClusterAdaptiveController(list(policies), period_s=period_s, **kw)


def build_controller(
    policies: Union["AdaptiveController", Sequence[AdaptivePolicy], None],
    period_s: float = 0.5,
) -> Optional[AdaptiveController]:
    """Normalize ``TraceConfig.adaptive`` / ``ServeEngine(adaptive=…)`` input:
    pass through a ready controller, wrap a policy list, map None to None."""
    if policies is None:
        return None
    if isinstance(policies, AdaptiveController):
        return policies
    return AdaptiveController(list(policies), period_s=period_s)
