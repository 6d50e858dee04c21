"""The port's cluster-scope adaptive control, the twin of
``tests/test_cluster.py`` against ``repro_torch.core.{adaptive,stream}``: the
per-rank breakdown (retention through delta/resync frames, ``query_ranks``
over a forwarder tree, by-rank subscribe) and the policies that read it
(StragglerRankPolicy, RankImbalanceAdvisoryPolicy) — all clock-driven, no
sleeps in the policy tests.  The controller's straggler reports go to a
list here; the trainer's watchdog, which takes them in training, has its
twins in ``test_torch_trainer.py``."""

import socket
import time

import pytest

from repro_torch.core.adaptive import (
    ClusterAdaptiveController,
    ClusterContext,
    ClusterPolicy,
    RankImbalanceAdvisoryPolicy,
    StragglerRankPolicy,
    build_cluster_controller,
)
from repro_torch.core.aggregate import merge_tallies
from repro_torch.core.plugins.tally import ApiStat, Tally, render_by_rank
from repro_torch.core.stream import MasterServer, SnapshotStreamer, StreamClient


def mk_tally(rank: int, calls: int = 10, ns: int = 1000) -> Tally:
    t = Tally()
    t.hostnames.add(f"node{rank // 8:03d}")
    t.processes.add(rank)
    t.threads.add((rank, 1))
    st = ApiStat()
    for _ in range(calls):
        st.add(ns)
    t.apis[("ust_repro", "decode_step")] = st
    return t


def grow(t: Tally, calls: int, ns: int = 1000) -> Tally:
    for _ in range(calls):
        t.apis[("ust_repro", "decode_step")].add(ns)
    return t


def totals(t: Tally):
    out = {}
    for label, table in (("host", t.apis), ("device", t.device_apis)):
        for key, st in table.items():
            out[(label,) + key] = (st.calls, st.total_ns)
    return out


def wait_until(pred, timeout_s=5.0, period_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period_s)
    return pred()


# ---------------------------------------------------------------------------
# Per-rank retention at a single master
# ---------------------------------------------------------------------------


def test_master_retains_per_rank_across_delta_frames():
    """The stored per-source map must track each sender's cumulative state
    exactly while deltas, not full snapshots, carry the updates."""
    with MasterServer(port=0) as m:
        streamers = {}
        tallies = {}
        for r in range(3):
            s = SnapshotStreamer(m.addr, source=f"rank{r}")
            t = mk_tally(r, calls=3 + r)
            assert s.push(t)
            streamers[r], tallies[r] = s, t
        for s in streamers.values():
            assert wait_until(lambda s=s: (s.poll_control() or True) and s.peer_version == 2)
        for _ in range(4):  # steady state: every update a delta
            for r, s in streamers.items():
                grow(tallies[r], calls=1, ns=100 * (r + 1))
                assert s.push(tallies[r])
        assert all(s.delta_frames >= 3 for s in streamers.values())
        assert wait_until(
            lambda: all(
                m.ranks().get(f"rank{r}", Tally()).to_obj() == tallies[r].to_obj()
                for r in range(3)
            )
        )
        for s in streamers.values():
            s.close()


def test_master_retains_per_rank_across_resync():
    """Master-side state loss on one source: resync heals that source's
    entry, the other sources' entries stay intact."""
    with MasterServer(port=0) as m:
        s0 = SnapshotStreamer(m.addr, source="rank0")
        s1 = SnapshotStreamer(m.addr, source="rank1")
        t0, t1 = mk_tally(0, calls=2), mk_tally(1, calls=5)
        assert s0.push(t0) and s1.push(t1)
        assert wait_until(lambda: (s0.poll_control() or True) and s0.peer_version == 2)
        grow(t0, 1)
        assert s0.push(t0)
        assert s0.delta_frames >= 1
        # simulate master losing rank0's state with the connection still up
        assert wait_until(lambda: len(m.ranks()) == 2)
        with m._lock:
            del m._latest["rank0"]
        grow(t0, 1)
        assert s0.push(t0)  # delta lands on no state → rejected → resync
        assert wait_until(lambda: (s0.poll_control() or True) and s0.resyncs >= 1)
        grow(t0, 1)
        assert s0.push(t0)  # forced full snapshot heals rank0
        assert wait_until(
            lambda: m.ranks().get("rank0", Tally()).to_obj() == t0.to_obj()
        )
        assert m.ranks()["rank1"].to_obj() == t1.to_obj()  # untouched bystander
        s0.close()
        s1.close()


def test_ranks_returns_defensive_copies():
    m = MasterServer(port=0)
    m.submit("r0", mk_tally(0))
    r1 = m.ranks()
    grow(r1["r0"], calls=50)  # mutating the copy must not corrupt the store
    assert m.ranks()["r0"].apis[("ust_repro", "decode_step")].calls == 10


# ---------------------------------------------------------------------------
# query_ranks over the forwarder tree
# ---------------------------------------------------------------------------


def test_query_ranks_two_level_tree_matches_per_rank_truth():
    """rank → local master → global master: `query_ranks` at the root must
    equal the per-rank truth, and its merge must equal the composite."""
    truth = {}
    with MasterServer(port=0) as g:
        with MasterServer(port=0, forward_to=g.addr, forward_period_s=0.05) as l:
            for r in range(4):
                s = SnapshotStreamer(l.addr, source=f"rank{r}")
                t = mk_tally(r, calls=5 + r, ns=1000 + r)
                assert s.push(t)
                s.close()
                truth[f"rank{r}"] = t
            with StreamClient(g.addr) as c:
                assert wait_until(
                    lambda: set(c.ranks()[0]) == set(truth)
                    and all(
                        c.ranks()[0][k].to_obj() == truth[k].to_obj()
                        for k in truth
                    )
                )
                ranks, meta = c.ranks()
                assert meta["sources"] == 4
                assert set(meta["ts"]) == set(truth)
                # per-rank sums equal the merged composite, API for API
                comp, _ = c.composite()
            merged, _ = merge_tallies([Tally().merge(t) for t in ranks.values()])
            assert totals(merged) == totals(comp)
            assert merged.hostnames == comp.hostnames


def test_query_ranks_empty_master():
    with MasterServer(port=0) as m:
        with StreamClient(m.addr) as c:
            ranks, meta = c.ranks()
        assert ranks == {} and meta["sources"] == 0


def test_subscribe_by_rank_pushes_breakdown():
    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0, calls=3))
        m.submit("r1", mk_tally(1, calls=7))
        got = []
        with StreamClient(m.addr) as c:
            for t, meta in c.subscribe(period_s=0.05, by_rank=True):
                got.append((t, meta))
                if len(got) >= 2:
                    break
        ranks = got[0][1]["ranks"]
        assert set(ranks) == {"r0", "r1"}
        assert ranks["r0"].apis[("ust_repro", "decode_step")].calls == 3
        assert ranks["r1"].apis[("ust_repro", "decode_step")].calls == 7
        # heartbeat re-yields the cached breakdown
        assert got[1][1].get("unchanged") and set(got[1][1]["ranks"]) == {"r0", "r1"}


def test_render_by_rank_table():
    out = render_by_rank({"r0": mk_tally(0, calls=2), "r1": mk_tally(1, calls=8)})
    assert "2 ranks" in out and "r0" in out and "r1" in out
    assert "decode_step" in out  # top API column
    lines = out.splitlines()
    assert lines[2].startswith("-")  # header separator
    # sorted by time: r1 (8 calls) first
    assert lines.index([l for l in lines if l.startswith("r1")][0]) < lines.index(
        [l for l in lines if l.startswith("r0")][0]
    )


def test_iprof_top_by_rank_poll_mode(capsys):
    from repro_torch.core.iprof import main as iprof

    with MasterServer(port=0) as m:
        m.submit("rank0", mk_tally(0))
        m.submit("rank1", mk_tally(1))
        rc = iprof(["top", m.addr, "--by-rank", "--iterations", "1", "--no-clear"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "-- ranks --" in out and "rank0" in out and "rank1" in out
    assert "2 sources" in out


def test_iprof_top_by_rank_live_mode(capsys):
    from repro_torch.core.iprof import main as iprof

    with MasterServer(port=0) as m:
        m.submit("rank0", mk_tally(0))
        rc = iprof(
            [
                "top",
                m.addr,
                "--live",
                "--by-rank",
                "--interval",
                "0.05",
                "--iterations",
                "2",
                "--no-clear",
            ]
        )
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("-- ranks --") == 2 and "rank0" in out


# ---------------------------------------------------------------------------
# Cluster controller + policies (explicit clocks, no sleeps)
# ---------------------------------------------------------------------------


def rank_map(latencies_ns, base=None, calls=5):
    """Synthetic per-rank map: each rank's decode_step grew `calls` calls at
    its given latency since `base` (cumulative, the wire shape)."""
    out = {}
    for src, ns in latencies_ns.items():
        t = Tally().merge(base[src]) if base and src in base else mk_tally(0, calls=0)
        grow(t, calls=calls, ns=ns)
        out[src] = t
    return out


def test_straggler_rank_policy_fires_on_synthetic_slow_rank():
    flagged = []
    pol = StragglerRankPolicy(
        "ust_repro", "decode_step", ratio=2.0, metric="latency", patience=2
    )
    ctrl = ClusterAdaptiveController(
        [pol], on_straggler=lambda *a: flagged.append(a), clock=lambda: 0.0
    )
    lat = {"r0": 1000, "r1": 1100, "r2": 900, "r3": 20_000}
    cur = rank_map(lat)
    assert not ctrl.observe(cur, now=0.0)  # baseline
    prev = cur
    cur = rank_map(lat, base=prev)
    assert ctrl.observe(cur, now=1.0)  # strike 1: patience not yet met
    assert not flagged and pol._strikes["r3"] == 1
    prev = cur
    cur = rank_map(lat, base=prev)
    assert ctrl.observe(cur, now=2.0)  # strike 2: flag fires
    assert len(flagged) == 1
    source, provider, api, ratio, reason = flagged[0]
    assert source == "r3" and (provider, api) == ("ust_repro", "decode_step")
    assert ratio == pytest.approx(20_000 / 1050, rel=0.01)  # vs cluster median
    assert "median" in reason
    acts = [a for a in ctrl.actions if a.knob == "straggler:r3"]
    assert acts and "decode_step" in acts[0].value
    # flag fires once, not every window
    prev = cur
    cur = rank_map(lat, base=prev)
    ctrl.observe(cur, now=3.0)
    assert len(flagged) == 1


def test_straggler_rank_policy_recovery_rearms():
    flagged = []
    pol = StragglerRankPolicy("ust_repro", "decode_step", ratio=2.0, patience=1)
    ctrl = ClusterAdaptiveController(
        [pol], on_straggler=lambda *a: flagged.append(a), clock=lambda: 0.0
    )
    slow = {"r0": 1000, "r1": 1000, "r2": 30_000}
    healthy = {"r0": 1000, "r1": 1000, "r2": 1000}
    cur = rank_map(slow)
    ctrl.observe(cur, now=0.0)
    cur = rank_map(slow, base=cur)
    ctrl.observe(cur, now=1.0)
    assert len(flagged) == 1 and "r2" in pol.flagged
    cur = rank_map(healthy, base=cur)
    ctrl.observe(cur, now=2.0)  # recovery window
    assert "r2" not in pol.flagged
    assert any(a.value == "recovered" for a in ctrl.actions)
    cur = rank_map(slow, base=cur)
    ctrl.observe(cur, now=3.0)  # re-armed: lagging again re-flags
    assert len(flagged) == 2


def test_straggler_policy_needs_min_ranks_and_activity():
    """A rank idle in the window (no calls) is excluded; a single active
    rank can never be a straggler relative to itself."""
    flagged = []
    pol = StragglerRankPolicy("ust_repro", "decode_step", ratio=1.5, patience=1)
    ctrl = ClusterAdaptiveController(
        [pol], on_straggler=lambda *a: flagged.append(a), clock=lambda: 0.0
    )
    cur = rank_map({"r0": 1000, "r1": 50_000})
    ctrl.observe(cur, now=0.0)
    # only r1 active this window: r0's tally did not move
    nxt = {"r0": Tally().merge(cur["r0"]), "r1": grow(Tally().merge(cur["r1"]), 5, 50_000)}
    ctrl.observe(nxt, now=1.0)
    assert not flagged


def test_straggler_streak_broken_by_idle_window():
    """'patience consecutive windows' means consecutive: a window where the
    lagging rank is idle (or the cluster lacks a quorum) resets its strikes."""
    flagged = []
    pol = StragglerRankPolicy("ust_repro", "decode_step", ratio=2.0, patience=2)
    ctrl = ClusterAdaptiveController(
        [pol], on_straggler=lambda *a: flagged.append(a), clock=lambda: 0.0
    )
    slow = {"r0": 1000, "r1": 1000, "r2": 30_000}
    cur = rank_map(slow)
    ctrl.observe(cur, now=0.0)
    cur = rank_map(slow, base=cur)
    ctrl.observe(cur, now=1.0)  # strike 1
    assert pol._strikes["r2"] == 1
    # r2 idle this window: only r0/r1 move
    idle = {
        "r0": grow(Tally().merge(cur["r0"]), 5, 1000),
        "r1": grow(Tally().merge(cur["r1"]), 5, 1000),
        "r2": Tally().merge(cur["r2"]),
    }
    ctrl.observe(idle, now=2.0)
    assert pol._strikes.get("r2", 0) == 0  # streak broken
    cur = rank_map(slow, base=idle)
    ctrl.observe(cur, now=3.0)  # strike 1 again — patience 2 not met
    assert not flagged
    cur = rank_map(slow, base=cur)
    ctrl.observe(cur, now=4.0)  # strike 2: now it fires
    assert len(flagged) == 1


def test_flag_rearms_after_idle_so_new_excursion_reports():
    """A flagged rank that goes idle ends its excursion: when it resumes
    and lags again, the new excursion must be reported again."""
    flagged = []
    pol = StragglerRankPolicy("ust_repro", "decode_step", ratio=2.0, patience=1)
    ctrl = ClusterAdaptiveController(
        [pol], on_straggler=lambda *a: flagged.append(a), clock=lambda: 0.0
    )
    slow = {"r0": 1000, "r1": 1000, "r2": 30_000}
    cur = rank_map(slow)
    ctrl.observe(cur, now=0.0)
    cur = rank_map(slow, base=cur)
    ctrl.observe(cur, now=1.0)
    assert len(flagged) == 1 and "r2" in pol.flagged
    # r2 idle: excursion over, flag re-arms without a recovery window
    idle = {
        "r0": grow(Tally().merge(cur["r0"]), 5, 1000),
        "r1": grow(Tally().merge(cur["r1"]), 5, 1000),
        "r2": Tally().merge(cur["r2"]),
    }
    ctrl.observe(idle, now=2.0)
    assert "r2" not in pol.flagged
    cur = rank_map(slow, base=idle)
    ctrl.observe(cur, now=3.0)  # lagging again: second excursion reported
    assert len(flagged) == 2


def test_subscribe_by_rank_frame_internally_consistent():
    """Invariant 7 inside one frame: the pushed ranks map merges to exactly
    the pushed composite."""
    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0, calls=3))
        m.submit("r1", mk_tally(1, calls=7))
        msg = m._composite_msg(by_rank=True)
        ranks = {s: Tally.from_obj(o) for s, o in msg["ranks"].items()}
        merged, _ = merge_tallies([Tally().merge(t) for t in ranks.values()])
        assert merged.to_obj() == Tally.from_obj(msg["tally"]).to_obj()


def test_new_rank_baselines_not_flagged():
    """A rank joining mid-run must not have its whole cumulative history
    (jit compiles included) counted as one window — no false flag."""
    flagged = []
    pol = StragglerRankPolicy("ust_repro", "decode_step", ratio=2.0, patience=1)
    ctrl = ClusterAdaptiveController(
        [pol], on_straggler=lambda *a: flagged.append(a), clock=lambda: 0.0
    )
    lat = {"r0": 1000, "r1": 1100}
    cur = rank_map(lat)
    ctrl.observe(cur, now=0.0)
    # r2 appears with a huge compile-heavy cumulative tally
    nxt = rank_map(lat, base=cur)
    nxt["r2"] = mk_tally(2, calls=3, ns=500_000)
    ctrl.observe(nxt, now=1.0)
    assert not flagged  # r2 baselined, not judged on its history
    # from its next window on, r2 is judged on fresh activity only
    fin = rank_map({**lat, "r2": 1200}, base=nxt)
    ctrl.observe(fin, now=2.0)
    assert not flagged


def test_tick_backoff_applies_to_failed_fetches():
    """An unreachable master is retried once per period_s, not once per
    caller iteration — the consumer/decode loop must not stall every pass."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    clock = {"t": 0.0}
    fetches = []
    ctrl = ClusterAdaptiveController(
        [], addr=f"127.0.0.1:{port}", period_s=1.0, timeout_s=0.2,
        clock=lambda: clock["t"],
    )
    orig = ctrl._fetch
    ctrl._fetch = lambda: fetches.append(clock["t"]) or orig()
    for t in (0.0, 0.1, 0.2, 1.5, 1.6):
        clock["t"] = t
        ctrl.tick()
    assert fetches == [0.0, 1.5]  # one attempt per period, failures included


def test_forward_ranks_flush_skips_clean_sources():
    """Per-source dirty tracking: a flush after one source updated pushes
    only that source's frame upstream."""
    with MasterServer(port=0) as g:
        with MasterServer(port=0, forward_to=g.addr, forward_period_s=30) as l:
            l.submit("r0", mk_tally(0, calls=3))
            l.submit("r1", mk_tally(1, calls=4))
            assert l.flush(force=True)
            base_pushed = l.forwarder.pushed
            t = mk_tally(0, calls=9)
            l.submit("r0", t)  # only r0 moves
            assert l.flush()
            assert l.forwarder.pushed == base_pushed + 1  # r1 not re-sent
            assert not l.flush()  # nothing dirty: no-op
            assert wait_until(
                lambda: g.ranks().get("r0", Tally()).to_obj() == t.to_obj()
            )


def test_rank_imbalance_advisory_hysteresis():
    pol = RankImbalanceAdvisoryPolicy("ust_repro", "decode_step", high=2.0, low=1.2)
    ctrl = ClusterAdaptiveController([pol], clock=lambda: 0.0)
    skewed = {"r0": 500, "r1": 600, "r2": 10_000}
    flat = {"r0": 1000, "r1": 1000, "r2": 1000}
    cur = rank_map(skewed)
    ctrl.observe(cur, now=0.0)
    cur = rank_map(skewed, base=cur)
    ctrl.observe(cur, now=1.0)
    highs = [a for a in ctrl.actions if a.value == "high"]
    assert len(highs) == 1 and highs[0].knob == "imbalance:ust_repro:decode_step"
    cur = rank_map(skewed, base=cur)
    ctrl.observe(cur, now=2.0)  # still high: no duplicate advisory
    assert len([a for a in ctrl.actions if a.value == "high"]) == 1
    cur = rank_map(flat, base=cur)
    ctrl.observe(cur, now=3.0)
    assert any(a.value == "low" for a in ctrl.actions)


def test_cluster_context_metrics():
    prev = {"r0": mk_tally(0, calls=10, ns=1000), "r1": mk_tally(1, calls=10, ns=1000)}
    cur = {
        "r0": grow(Tally().merge(prev["r0"]), calls=4, ns=1000),
        "r1": grow(Tally().merge(prev["r1"]), calls=2, ns=9000),
        "r2": mk_tally(2, calls=3, ns=500),  # appeared mid-run
    }
    ctx = ClusterContext(ClusterAdaptiveController([]), prev, cur, window_s=2.0)
    assert ctx.rank_ids() == ["r0", "r1", "r2"]
    assert ctx.window("r0", "ust_repro", "decode_step") == (4, 4000)
    # r2 joined mid-run: its cumulative history (compiles included) is not a
    # window — it baselines now and contributes from the next observation
    assert ctx.window("r2", "ust_repro", "decode_step") == (0, 0)
    assert ctx.window("r9", "ust_repro", "decode_step") == (0, 0)
    assert ctx.latency_ns("r1", "ust_repro", "decode_step") == 9000
    assert ctx.busy_fraction("r1", "ust_repro", "decode_step") == pytest.approx(
        18_000 / 2e9
    )
    lat = ctx.latency_by_rank("ust_repro", "decode_step")
    assert lat == {"r0": 1000.0, "r1": 9000.0}  # r2 baselining, excluded
    skew = ctx.skew_by_rank("ust_repro", "decode_step")
    assert skew["r1"] == pytest.approx(9000.0 / 5000.0)  # vs median of r0/r1
    assert ctx.skew_by_rank("ust_repro", "nothing") == {}


def test_cluster_controller_ticks_from_in_process_master_with_clock():
    """tick() against a live (socketless) MasterServer store, clock-driven:
    rate limiting and window math use the injected clock only."""
    clock = {"t": 0.0}
    flagged = []
    m = MasterServer(port=0)  # not started: pure in-process state store
    ctrl = ClusterAdaptiveController(
        [StragglerRankPolicy("ust_repro", "decode_step", ratio=2.0, patience=1)],
        master=m,
        period_s=1.0,
        on_straggler=lambda *a: flagged.append(a),
        clock=lambda: clock["t"],
    )
    lat = {"r0": 1000, "r1": 1000, "r2": 25_000}
    state = rank_map(lat)
    for src, t in state.items():
        m.submit(src, Tally().merge(t))
    assert not ctrl.tick()  # baseline
    assert not ctrl.tick()  # rate-limited: clock has not advanced
    state = rank_map(lat, base=state)
    for src, t in state.items():
        m.submit(src, Tally().merge(t))
    clock["t"] = 1.5
    assert ctrl.tick()
    assert flagged and flagged[0][0] == "r2"


def test_policy_exception_isolated():
    class Exploding(ClusterPolicy):
        name = "exploding"

        def tick(self, ctx):
            raise RuntimeError("boom")

    survivor = RankImbalanceAdvisoryPolicy("ust_repro", "decode_step", high=1.5)
    ctrl = ClusterAdaptiveController([Exploding(), survivor], clock=lambda: 0.0)
    skewed = rank_map({"r0": 500, "r1": 10_000})
    ctrl.observe(skewed, now=0.0)
    ctrl.observe(rank_map({"r0": 500, "r1": 10_000}, base=skewed), now=1.0)
    assert any(a.policy == "rank-imbalance" for a in ctrl.actions)


def test_build_cluster_controller_normalization():
    ctrl = ClusterAdaptiveController([], period_s=0.2)
    assert build_cluster_controller(ctrl) is ctrl
    assert build_cluster_controller(None) is None
    built = build_cluster_controller(
        [StragglerRankPolicy("p", "a")], period_s=0.7
    )
    assert isinstance(built, ClusterAdaptiveController) and built.period_s == 0.7


def test_straggler_policy_rejects_unknown_metric():
    with pytest.raises(ValueError):
        StragglerRankPolicy("p", "a", metric="vibes")


def test_cluster_controller_fetch_unreachable_addr_is_quiet():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    ctrl = ClusterAdaptiveController(
        [], addr=f"127.0.0.1:{port}", timeout_s=0.2, clock=lambda: 0.0
    )
    assert not ctrl.tick()  # master absent: adaptation pauses, never raises


# ---------------------------------------------------------------------------
# Tracer wiring
# ---------------------------------------------------------------------------


def test_traceconfig_cluster_adaptive_requires_serve_port(tmp_path):
    from repro_torch.core import TraceConfig

    with pytest.raises(ValueError):
        TraceConfig(
            out_dir=str(tmp_path),
            cluster_adaptive=[StragglerRankPolicy("ust_repro", "decode_step")],
        )


def test_tracer_ticks_cluster_controller_and_records_advisory(tmp_path):
    """End to end inside one process: a serve_port session ingests two fake
    remote ranks, the cluster controller (clock-driven) flags the slow one,
    the advisory lands in this session's trace, and the
    straggler channel receives the evidence."""
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.babeltrace import CTFSource

    clock = {"t": 0.0}
    reports = []  # (source, provider, api, ratio, reason), the watchdog's channel
    ctrl = ClusterAdaptiveController(
        [StragglerRankPolicy("ust_repro", "decode_step", ratio=2.0, patience=1)],
        period_s=0.0,  # every consumer tick; windows advance via the clock
        on_straggler=lambda *a: reports.append(a),
        clock=lambda: clock["t"],
    )
    cfg = TraceConfig(
        out_dir=str(tmp_path / "t"),
        mode="default",
        serve_port=0,
        cluster_adaptive=ctrl,
        flush_period_s=0.01,
    )
    lat = {"rankA": 1000, "rankB": 1000, "rankC": 40_000}
    with Tracer(cfg) as tr:
        assert tr.cluster is ctrl and ctrl.master is tr.server
        state = rank_map(lat)
        for src, t in state.items():
            tr.server.submit(src, Tally().merge(t))
        assert wait_until(lambda: ctrl._prev is not None)  # baseline consumed
        state = rank_map(lat, base=state)
        for src, t in state.items():
            tr.server.submit(src, Tally().merge(t))
        clock["t"] = 1.0
        assert wait_until(lambda: len(reports) >= 1)
    source, _, api, ratio, _ = reports[0]
    assert source == "rankC" and api == "decode_step" and ratio > 2.0
    advisories = [
        ev for ev in CTFSource(tr.handle.trace_dir) if ev.name == "ust_repro:advisory"
    ]
    assert advisories and advisories[0].fields[0] == "straggler-rank"
    assert "straggler:rankC" in advisories[0].fields[1]

