"""The port's adaptive-optimization consumer (§6), the twin of
``tests/test_adaptive.py`` against ``repro_torch.core.adaptive``: windowed
metrics, policy knob turns mid-run, and advisory events in the trace.  The
live sessions run the port's decode-step spans; the serving engine's hook is
held in ``test_torch_live_serve.py``.  Every wait has its own deadline."""

import time

from repro_torch.core.adaptive import (
    AdaptiveContext,
    AdaptiveController,
    AdaptivePolicy,
    RingPressurePolicy,
    StreamCadencePolicy,
    ThresholdAdvisoryPolicy,
    WidenSamplingPolicy,
    build_controller,
)
from repro_torch.core.plugins.tally import ApiStat, Tally


def tally_with(calls: int, total_ns: int) -> Tally:
    t = Tally()
    st = ApiStat()
    for _ in range(calls):
        st.add(total_ns // calls)
    t.apis[("ust_repro", "decode_step")] = st
    return t


def mk_ctx(prev: Tally, cur: Tally, window_s: float = 1.0) -> AdaptiveContext:
    ctrl = AdaptiveController([], period_s=0.01)
    return AdaptiveContext(ctrl, prev, cur, window_s)


# ---------------------------------------------------------------------------
# Windowed metrics
# ---------------------------------------------------------------------------


def test_windowed_busy_fraction_uses_deltas_not_cumulative():
    prev = tally_with(calls=10, total_ns=900_000_000)  # busy history...
    cur = Tally().merge(prev)
    cur.apis[("ust_repro", "decode_step")].add(100_000_000)  # ...quiet window
    ctx = mk_ctx(prev, cur, window_s=1.0)
    assert abs(ctx.busy_fraction("ust_repro", "decode_step") - 0.1) < 1e-9
    assert ctx.window_calls("ust_repro", "decode_step") == 1
    assert ctx.window_latency_ns("ust_repro", "decode_step") == 100_000_000


def test_windowed_metrics_for_new_and_absent_apis():
    prev = Tally()
    cur = tally_with(calls=4, total_ns=200_000_000)
    ctx = mk_ctx(prev, cur, window_s=2.0)
    assert abs(ctx.busy_fraction("ust_repro", "decode_step") - 0.1) < 1e-9
    assert ctx.busy_fraction("ust_repro", "never_called") == 0.0
    assert ctx.window_latency_ns("ust_repro", "never_called") == 0.0


# ---------------------------------------------------------------------------
# Policies against a live tracing session
# ---------------------------------------------------------------------------


def run_traced_steps(tmp_path, policies, steps=6, step_sleep=0.01, **cfg_kw):
    """Drive a real online session with decode_step spans and the policies."""
    from repro_torch.core import TraceConfig, Tracer, decode_step_span

    cfg = TraceConfig(
        out_dir=str(tmp_path / "t"),
        mode="default",
        adaptive=policies,
        adaptive_period_s=0.02,
        flush_period_s=0.01,
        **cfg_kw,
    )
    assert cfg.online  # adaptive implies the live tally
    with Tracer(cfg) as tr:
        for s in range(steps):
            with decode_step_span(s, 2, 32) as sp:
                time.sleep(step_sleep)
                sp.outs["tokens_out"] = 2
        deadline = time.monotonic() + 5.0
        while not tr.adaptive.actions and time.monotonic() < deadline:
            time.sleep(0.02)
    return tr


def test_widen_sampling_policy_turns_event_knob_mid_run(tmp_path):
    """The acceptance behavior: busy_fraction over a live window flips a
    tracepoint enable bit while the session is still running."""
    from repro_torch.core import TraceConfig, Tracer, decode_step_span

    pol = WidenSamplingPolicy(
        "ust_repro",
        "decode_step",
        widen_events=["ust_repro:poll_ready_entry"],
        high=0.05,  # sleeping inside the span guarantees crossing this
        low=1.1,  # never re-narrow during the test
    )
    cfg = TraceConfig(
        out_dir=str(tmp_path / "t"),
        mode="default",
        adaptive=[pol],
        adaptive_period_s=0.02,
        flush_period_s=0.01,
    )
    with Tracer(cfg) as tr:
        ev = tr.model.by_name()["ust_repro:poll_ready_entry"]
        assert tr.tp.enabled[ev.eid] == 0  # excluded by the default mode
        deadline = time.monotonic() + 5.0
        s = 0
        while not pol.widened and time.monotonic() < deadline:
            with decode_step_span(s, 2, 32) as sp:
                time.sleep(0.02)
                sp.outs["tokens_out"] = 2
            s += 1
        # the knob really turned, while the session was still live
        assert pol.widened and tr.tp.enabled[ev.eid] == 1
    acts = [a for a in tr.adaptive.actions if a.knob == "event:ust_repro:poll_ready_entry"]
    assert acts and acts[0].value == "on"
    assert "busy_fraction" in acts[0].reason


def test_stream_cadence_policy_retunes_stream_period(tmp_path):
    pol = StreamCadencePolicy(
        "ust_repro", "decode_step", high=0.05, low=0.0, fast_s=0.03, slow_s=2.0
    )
    tr = run_traced_steps(tmp_path, [pol], step_sleep=0.02, stream_period_s=0.5)
    assert tr.cfg.stream_period_s == 0.03  # changed mid-run from busy_fraction
    assert any(a.knob == "stream_period_s" for a in tr.adaptive.actions)


def test_advisory_event_lands_in_the_trace(tmp_path):
    from repro_torch.core.babeltrace import CTFSource

    pol = ThresholdAdvisoryPolicy("ust_repro", "decode_step", high=0.05, low=0.0)
    tr = run_traced_steps(tmp_path, [pol], step_sleep=0.02)
    assert any(a.knob.startswith("busy:") for a in tr.adaptive.actions)
    advisories = [
        ev for ev in CTFSource(tr.handle.trace_dir) if ev.name == "ust_repro:advisory"
    ]
    assert advisories, "advisory events must be recorded into the trace"
    policy_name, knob, detail = advisories[0].fields[:3]
    assert policy_name == "threshold-advisory"
    assert knob.startswith("busy:ust_repro:decode_step")
    assert "busy_fraction" in detail


def test_ring_pressure_policy_grows_capacity():
    """Duck-typed tracer: the policy doubles future-ring capacity when the
    window shows drops, and only advises once the cap is hit."""

    class FakeRegistry:
        def __init__(self):
            self._capacity = 1 << 12
            self.total_dropped = 0

        @property
        def capacity(self):
            return self._capacity

        def set_capacity(self, n):
            self._capacity = n

    class FakeOnline:
        def snapshot(self):
            return Tally()

    class FakeTracer:
        online = FakeOnline()
        registry = FakeRegistry()
        tp = None
        cfg = None

    ctrl = AdaptiveController(
        [RingPressurePolicy(factor=2.0, max_bytes=1 << 13)], period_s=0.0
    )
    ctrl.attach(FakeTracer())
    assert not ctrl.tick(force=True)  # baseline window
    FakeTracer.registry.total_dropped = 7
    assert ctrl.tick(force=True)
    assert FakeTracer.registry.capacity == 1 << 13
    assert any(a.knob == "ring_bytes" for a in ctrl.actions)
    # at the cap: advisory only, capacity stays
    FakeTracer.registry.total_dropped = 20
    ctrl.tick(force=True)
    assert FakeTracer.registry.capacity == 1 << 13


def test_policy_exception_does_not_stop_other_policies(tmp_path):
    class Exploding(AdaptivePolicy):
        name = "exploding"

        def tick(self, ctx):
            raise RuntimeError("boom")

    survivor = ThresholdAdvisoryPolicy("ust_repro", "decode_step", high=0.05, low=0.0)
    tr = run_traced_steps(tmp_path, [Exploding(), survivor], step_sleep=0.02)
    assert any(a.policy == "threshold-advisory" for a in tr.adaptive.actions)


def test_build_controller_normalization():
    ctrl = AdaptiveController([], period_s=0.1)
    assert build_controller(ctrl) is ctrl
    assert build_controller(None) is None
    built = build_controller([ThresholdAdvisoryPolicy("p", "a")], period_s=0.3)
    assert isinstance(built, AdaptiveController) and built.period_s == 0.3


def test_on_action_callback_observes_actions(tmp_path):
    seen = []
    ctrl = AdaptiveController(
        [ThresholdAdvisoryPolicy("ust_repro", "decode_step", high=0.05, low=0.0)],
        period_s=0.02,
        on_action=seen.append,
    )
    tr = run_traced_steps(tmp_path, ctrl, step_sleep=0.02)
    assert tr.adaptive is ctrl
    assert seen and seen[0].policy == "threshold-advisory"
    assert "busy_fraction" in str(seen[0])
