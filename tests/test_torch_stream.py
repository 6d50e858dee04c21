"""The port's streaming aggregation service (§3.7+§6), the twin of
``tests/test_stream.py`` against ``repro_torch.core.stream``: framing, the v2
delta protocol (encode/decode, mis-based frames, resync-after-reconnect),
master merge vs the offline batch combine, the forwarding tree, and
tracer-driven end-to-end with the port's spans and steps.  Then wire parity
with the JAX package: the same frames byte for byte, and a composite streamed
from either package's streamer into the other's master.  Every socket is on
127.0.0.1, port 0 (or a port just probed free), and every wait has its own
deadline.
"""

import socket
import time

import pytest
import torch

import repro.core.stream as jax_stream
from repro.core.plugins.tally import ApiStat as JaxApiStat
from repro.core.plugins.tally import Tally as JaxTally
from repro_torch.core import stream as torch_stream
from repro_torch.core.aggregate import combine_aggregates, save_tally
from repro_torch.core.plugins.tally import ApiStat, Tally
from repro_torch.core.stream import (
    MasterServer,
    ProtocolError,
    SnapshotStreamer,
    StreamClient,
    pack_frame,
    parse_addr,
    recv_frame,
)


def mk_tally(rank: int, calls: int = 10) -> Tally:
    t = Tally()
    t.hostnames.add(f"node{rank // 8:03d}")
    t.processes.add(rank)
    t.threads.add((rank, 1))
    st = ApiStat()
    for i in range(calls):
        st.add(1000 + rank + i)
    t.apis[("ust_repro", "train_step")] = st
    s2 = ApiStat()
    s2.add(50 * (rank + 1))
    t.device_apis[("ust_kernel", "k")] = s2
    return t


def totals(t: Tally):
    out = {}
    for label, table in (("host", t.apis), ("device", t.device_apis)):
        for key, st in table.items():
            out[(label,) + key] = (st.calls, st.total_ns)
    return out


def fetch_composite(addr, timeout_s=3.0):
    """One-shot composite read via the unified client."""
    with StreamClient(addr, timeout_s=timeout_s) as c:
        return c.composite()


def composite_calls(addr):
    """Calls of the train_step row in the master's composite; None while no
    frame that holds the row has been folded yet (frames may be in flight)."""
    st = fetch_composite(addr)[0].apis.get(("ust_repro", "train_step"))
    return None if st is None else st.calls


def wait_until(pred, timeout_s=5.0, period_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period_s)
    return pred()


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        msgs = [
            {"type": "hello", "source": "r0"},
            {"type": "snapshot", "seq": 3, "tally": mk_tally(2).to_obj()},
            {"type": "query"},
        ]
        for m in msgs:
            a.sendall(pack_frame(m))
        got = [recv_frame(b) for _ in msgs]
        assert got == msgs
        back = Tally.from_obj(got[1]["tally"])
        assert back.to_obj() == mk_tally(2).to_obj()
        a.close()
        assert recv_frame(b) is None  # clean EOF
    finally:
        b.close()


def test_frame_torn_mid_body_raises():
    a, b = socket.socketpair()
    try:
        frame = pack_frame({"type": "snapshot", "tally": mk_tally(0).to_obj()})
        a.sendall(frame[: len(frame) - 5])
        a.close()
        with pytest.raises(ProtocolError):
            recv_frame(b)
    finally:
        b.close()


def test_frame_oversize_announcement_raises():
    a, b = socket.socketpair()
    try:
        import struct

        a.sendall(struct.pack("!I", (64 << 20) + 1))
        with pytest.raises(ProtocolError):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_parse_addr():
    assert parse_addr("10.0.0.1:9000") == ("10.0.0.1", 9000)
    assert parse_addr(":9000") == ("127.0.0.1", 9000)
    assert parse_addr(("h", 1)) == ("h", 1)


# ---------------------------------------------------------------------------
# Delta encoding (protocol v2)
# ---------------------------------------------------------------------------


def grow(t: Tally, calls: int, extra_api: str = None) -> Tally:
    """Cumulatively grow a tally the way a live rank does."""
    for _ in range(calls):
        t.apis[("ust_repro", "train_step")].add(2000)
    if extra_api is not None:
        st = ApiStat()
        st.add(123)
        t.apis[("ust_repro", extra_api)] = st
    return t


def test_delta_roundtrip_through_msgpack():
    """delta_to → msgpack → apply_delta reproduces the newer cumulative
    state exactly, and the delta only carries the changed entries."""
    import msgpack

    base = mk_tally(0, calls=5)
    # a wide stable region the delta must NOT carry
    for i in range(50):
        st = ApiStat()
        st.add(10 + i)
        base.apis[("ust_torchrt", f"cold_{i}")] = st
    older = Tally().merge(base)
    grow(base, calls=3, extra_api="optimizer_update")
    base.hostnames.add("node999")

    d = base.delta_to(older)
    assert len(d["apis"]) == 2  # only train_step + the new API changed
    assert d["hostnames"] == ["node999"]
    d = msgpack.unpackb(msgpack.packb(d, use_bin_type=True), raw=False)
    rebuilt = Tally().merge(older).apply_delta(d)
    assert rebuilt.to_obj() == base.to_obj()


def test_delta_refuses_removed_entries():
    """Cumulative tallies never shrink; a shrunk 'current' state must raise
    so the streamer falls back to a full snapshot."""
    prev = mk_tally(0)
    cur = Tally().merge(prev)
    del cur.apis[("ust_repro", "train_step")]
    with pytest.raises(ValueError):
        cur.delta_to(prev)
    cur2 = Tally().merge(prev)
    cur2.hostnames = set()
    with pytest.raises(ValueError):
        cur2.delta_to(prev)
    # removal masked by an equal-size addition must still be caught
    cur3 = Tally().merge(prev)
    del cur3.apis[("ust_repro", "train_step")]
    st = ApiStat()
    st.add(1)
    cur3.apis[("ust_repro", "replacement")] = st
    with pytest.raises(ValueError):
        cur3.delta_to(prev)


def test_master_delta_out_of_order_and_duplicate_rejected():
    """A delta applies only on exact base_seq match: duplicates (already
    superseded base) and out-of-order frames (future base) are rejected
    without corrupting the stored cumulative state."""
    m = MasterServer(port=0)
    t = mk_tally(0, calls=5)
    m.submit("r0", Tally().merge(t), seq=0)

    older = Tally().merge(t)
    grow(t, calls=4)
    d1 = t.delta_to(older)
    assert m.submit_delta("r0", d1, seq=1, base_seq=0)
    assert m.composite().apis[("ust_repro", "train_step")].calls == 9

    # duplicate redelivery of the same delta: stored seq is 1, base is 0
    assert not m.submit_delta("r0", d1, seq=1, base_seq=0)
    # out-of-order / gapped delta: base_seq 5 never existed
    assert not m.submit_delta("r0", d1, seq=6, base_seq=5)
    # unknown source (e.g. master restarted and lost state)
    assert not m.submit_delta("rX", d1, seq=1, base_seq=0)
    assert m.composite().apis[("ust_repro", "train_step")].calls == 9
    assert m.stats()["deltas"] == 1


def test_streamer_switches_to_deltas_after_hello_ack():
    """Steady state on one connection: first push is a full snapshot, later
    pushes are deltas (once hello_ack lands), and the master state tracks
    the sender's cumulative tally exactly."""
    with MasterServer(port=0) as m:
        s = SnapshotStreamer(m.addr, source="r0")
        t = mk_tally(0, calls=5)
        assert s.push(t)
        assert s.full_frames == 1
        assert wait_until(lambda: (s.poll_control() or True) and s.peer_version is not None)
        for i in range(4):
            grow(t, calls=1)
            assert s.push(t)
        assert s.delta_frames >= 3  # at most one more full before the ack
        assert wait_until(
            lambda: composite_calls(m.addr) == 9
        )
        assert m.deltas >= 3
        s.close()


def test_streamer_resync_every_forces_full_frames():
    with MasterServer(port=0) as m:
        s = SnapshotStreamer(m.addr, source="r0", resync_every=2)
        t = mk_tally(0, calls=1)
        assert s.push(t)
        assert wait_until(lambda: (s.poll_control() or True) and s.peer_version == 2)
        for _ in range(6):
            grow(t, calls=1)
            assert s.push(t)
        # pattern after the ack: delta, delta, full, delta, delta, full…
        assert s.full_frames >= 3
        assert s.delta_frames >= 4
        assert wait_until(
            lambda: composite_calls(m.addr) == 7
        )
        s.close()


def test_resync_after_master_restart():
    """Master restarts (losing all state) while the streamer holds delta
    state: the dead connection is detected, the reconnect re-hellos, and
    the first frame on the new connection is a full snapshot that rebuilds
    the master."""
    m1 = MasterServer(port=0).start()
    s = SnapshotStreamer(m1.addr, source="r0", retry_s=0.01)
    t = mk_tally(0, calls=3)
    assert s.push(t)
    assert wait_until(lambda: (s.poll_control() or True) and s.peer_version == 2)
    grow(t, calls=2)
    assert s.push(t)
    assert s.delta_frames >= 1  # delta base state exists on this connection
    m1.stop()

    grow(t, calls=1)
    # the dead master's EOF reaches the streamer at some point after stop():
    # a push before then still lands in the socket's buffer, so wait for the
    # push that fails and drops the connection (and its delta base state)
    assert wait_until(lambda: not s.push(t), timeout_s=8.0)
    # "restarted" master: same role, empty state (fresh port sidesteps the
    # kernel's FIN_WAIT hold on the old one; the streamer state machine
    # can't tell the difference)
    with MasterServer(port=0) as m2:
        s.addr = parse_addr(m2.addr)
        assert wait_until(
            lambda: s.push(t)
            and m2.stats()["sources"] == 1
            and m2.composite().apis[("ust_repro", "train_step")].calls == 6,
            timeout_s=8.0,
        )
        assert m2.full_snapshots >= 1  # reconnect resynced with a full frame
    s.close()


def test_master_requests_resync_on_unknown_base():
    """A mis-based delta makes the master answer `resync`; the streamer's
    next push is then a full snapshot that heals the state."""
    with MasterServer(port=0) as m:
        s = SnapshotStreamer(m.addr, source="r0")
        t = mk_tally(0, calls=2)
        assert s.push(t)
        assert wait_until(lambda: (s.poll_control() or True) and s.peer_version == 2)
        grow(t, calls=1)
        assert s.push(t)
        assert s.delta_frames >= 1
        # simulate master-side state loss with the connection still up
        assert wait_until(lambda: m.stats()["sources"] == 1)
        m._latest.clear()
        grow(t, calls=1)
        assert s.push(t)  # delta lands on empty state → rejected → resync
        assert wait_until(lambda: (s.poll_control() or True) and s.resyncs >= 1)
        grow(t, calls=1)
        assert s.push(t)  # forced full
        assert wait_until(
            lambda: m.stats()["sources"] == 1
            and m.composite().apis[("ust_repro", "train_step")].calls == 5
        )
        assert m.resyncs_sent >= 1
        s.close()


def test_no_delta_mode_always_full():
    with MasterServer(port=0) as m:
        s = SnapshotStreamer(m.addr, source="r0", delta=False)
        t = mk_tally(0, calls=1)
        for _ in range(3):
            grow(t, calls=1)
            assert s.push(t)
        assert s.full_frames == 3 and s.delta_frames == 0
        s.close()


def test_subscribe_composites_pushes_updates():
    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0))
        got = []
        with StreamClient(m.addr) as c:
            for t, meta in c.subscribe(period_s=0.05):
                got.append((t, meta))
                if len(got) >= 3:
                    break
        assert all(
            t.apis[("ust_repro", "train_step")].calls == 10 for t, _ in got
        )
        assert got[0][1]["sources"] == 1
        # idle master: only the first push serializes the composite, later
        # periods are tally-less heartbeats re-yielding the cached tally
        assert "unchanged" not in got[0][1]
        assert got[1][1].get("unchanged") and got[2][1].get("unchanged")


def test_forward_delta_disabled_sends_full_frames_upstream():
    """MasterServer(forward_delta=False) must honor the full-snapshot wire
    behavior on its upstream hop (TraceConfig.stream_delta plumbs here)."""
    with MasterServer(port=0) as g:
        with MasterServer(
            port=0, forward_to=g.addr, forward_period_s=0.02, forward_delta=False
        ) as l:
            for calls in (3, 5, 8):
                l.submit("r0", mk_tally(0, calls=calls))
                l.flush(force=True)
            fwd = l.forwarder
            assert fwd.delta is False
            assert fwd.full_frames >= 3 and fwd.delta_frames == 0
            assert wait_until(lambda: composite_calls(g.addr) == 8)


# ---------------------------------------------------------------------------
# Master: merge correctness against the offline batch path
# ---------------------------------------------------------------------------


def test_master_merge_matches_combine_aggregates(tmp_path):
    """Streamed snapshots and `iprof combine` over the same tallies must
    produce the same composite."""
    n = 8
    paths = []
    for r in range(n):
        p = str(tmp_path / f"rank{r}.tally")
        save_tally(mk_tally(r), p)
        paths.append(p)
    offline = combine_aggregates(paths)

    with MasterServer(port=0) as m:
        for r in range(n):
            s = SnapshotStreamer(m.addr, source=f"rank{r}")
            assert s.push(mk_tally(r))
            s.close()
        assert wait_until(lambda: m.stats()["sources"] == n)
        live, meta = fetch_composite(m.addr)

    assert meta["sources"] == n
    assert totals(live) == totals(offline)
    assert live.hostnames == offline.hostnames
    assert live.processes == offline.processes


def test_master_latest_snapshot_wins():
    """Snapshots are cumulative: a source's newer push replaces (never adds
    to) its older one, so re-pushes don't double-count."""
    with MasterServer(port=0) as m:
        s = SnapshotStreamer(m.addr, source="r0")
        assert s.push(mk_tally(0, calls=5))
        assert s.push(mk_tally(0, calls=9))
        s.close()
        assert wait_until(lambda: m.stats()["snapshots"] == 2)
        t, _ = fetch_composite(m.addr)
    assert t.apis[("ust_repro", "train_step")].calls == 9


def test_master_ignores_stale_out_of_order_seq():
    m = MasterServer(port=0)
    m.submit("r0", mk_tally(0, calls=9), seq=5)
    m.submit("r0", mk_tally(0, calls=3), seq=2)  # stale duplicate
    assert m.composite().apis[("ust_repro", "train_step")].calls == 9


def test_master_composite_does_not_mutate_stored_tallies():
    m = MasterServer(port=0)
    for r in range(4):
        m.submit(f"r{r}", mk_tally(r))
    first = totals(m.composite())
    assert totals(m.composite()) == first  # idempotent across calls


def test_forward_tree_local_to_global():
    """rank → local master → global master: totals survive the hop, and (the
    forward_ranks default) every origin rank stays visible at the root."""
    with MasterServer(port=0) as g:
        with MasterServer(port=0, forward_to=g.addr, forward_period_s=0.05) as l:
            for r in range(4):
                s = SnapshotStreamer(l.addr, source=f"rank{r}")
                assert s.push(mk_tally(r))
                s.close()
            assert wait_until(lambda: l.stats()["sources"] == 4)
            expect = totals(l.composite())
            assert wait_until(
                lambda: g.stats()["sources"] == 4
                and totals(fetch_composite(g.addr)[0]) == expect
            )
            # per-rank identities pass through the hop
            _, meta = fetch_composite(g.addr)
            assert meta["sources"] == 4


def test_forward_tree_composite_mode_single_source():
    """forward_ranks=False restores the v2.0 behavior: the local master is
    one anonymous composite source at its parent."""
    with MasterServer(port=0) as g:
        with MasterServer(
            port=0, forward_to=g.addr, forward_period_s=0.05, forward_ranks=False
        ) as l:
            for r in range(4):
                s = SnapshotStreamer(l.addr, source=f"rank{r}")
                assert s.push(mk_tally(r))
                s.close()
            assert wait_until(lambda: l.stats()["sources"] == 4)
            expect = totals(l.composite())
            assert wait_until(
                lambda: g.stats()["sources"] == 1
                and totals(fetch_composite(g.addr)[0]) == expect
            )
            _, meta = fetch_composite(g.addr)
            assert meta["sources"] == 1


def test_forward_survives_parent_outage():
    """A failed upstream push must re-arm the forward trigger: the composite
    reaches the parent once it comes back, even with no new rank traffic."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    parent_port = probe.getsockname()[1]
    probe.close()  # parent not up yet
    local = MasterServer(
        port=0, forward_to=f"127.0.0.1:{parent_port}", forward_period_s=0.05
    ).start()
    local._forwarder.retry_s = 0.01
    try:
        local.submit("r0", mk_tally(0))
        assert not local.flush()  # parent down: push fails, trigger survives
        with MasterServer(port=parent_port) as parent:
            assert wait_until(lambda: parent.stats()["sources"] == 1)
            t, _ = fetch_composite(parent.addr)
            assert t.apis[("ust_repro", "train_step")].calls == 10
    finally:
        local.stop()


def test_master_new_session_same_source_not_stale():
    """A new session from the same source restarts seq at 0; its hello must
    reset the stored seq so the fresh snapshots aren't dropped as stale."""
    with MasterServer(port=0) as m:
        s1 = SnapshotStreamer(m.addr, source="r0")
        for calls in (3, 5, 7):  # seqs 0,1,2
            assert s1.push(mk_tally(0, calls=calls))
        s1.close()
        assert wait_until(lambda: m.stats()["snapshots"] == 3)
        s2 = SnapshotStreamer(m.addr, source="r0")  # seq restarts at 0
        assert s2.push(mk_tally(0, calls=9))
        s2.close()
        assert wait_until(lambda: m.stats()["snapshots"] == 4)
        t, _ = fetch_composite(m.addr)
    assert t.apis[("ust_repro", "train_step")].calls == 9


def test_streamer_drops_without_master_then_recovers():
    """No master listening: pushes are dropped, tracing is never disturbed;
    once a master appears the next cumulative push lands in full."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listening here now
    s = SnapshotStreamer(f"127.0.0.1:{port}", source="r0", retry_s=0.01)
    assert not s.push(mk_tally(0))
    assert s.dropped == 1
    with MasterServer(port=port) as m:
        assert wait_until(lambda: s.push(mk_tally(0, calls=7)), timeout_s=2.0)
        assert wait_until(lambda: m.stats()["sources"] == 1)
        t, _ = fetch_composite(m.addr)
        assert t.apis[("ust_repro", "train_step")].calls == 7
    s.close()


# ---------------------------------------------------------------------------
# iprof top CLI against a live master
# ---------------------------------------------------------------------------


def test_iprof_top_renders_composite(capsys):
    from repro_torch.core.iprof import main as iprof

    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0))
        rc = iprof(["top", m.addr, "--iterations", "1", "--no-clear"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "train_step" in out and "1 sources" in out
    assert "-- device --" in out  # mk_tally has device rows


def test_iprof_top_live_subscribe_mode(capsys):
    from repro_torch.core.iprof import main as iprof

    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0))
        rc = iprof(
            ["top", m.addr, "--live", "--interval", "0.05", "--iterations", "2", "--no-clear"]
        )
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("[iprof top]") == 2 and "train_step" in out


def test_iprof_top_unreachable_master(capsys):
    from repro_torch.core.iprof import main as iprof

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    rc = iprof(["top", f"127.0.0.1:{port}", "--iterations", "1", "--timeout", "0.2"])
    assert rc == 1


# ---------------------------------------------------------------------------
# Tracer-driven end-to-end
# ---------------------------------------------------------------------------


def _traced_steps(n: int, name: str, pause_s: float = 0.0) -> None:
    """``n`` decode-step spans, each around one traced CPU step."""
    from repro_torch.core import TracedStep, decode_step_span

    f = TracedStep(lambda x: (x + 1).sum(), name=name, device="cpu")
    x = torch.arange(64.0)
    for s_ in range(n):
        with decode_step_span(s_, 2, 32) as sp:
            f(x)
            sp.outs["tokens_out"] = 2
        time.sleep(pause_s)


def test_tracer_streams_final_tally_matching_offline(tmp_path):
    """Single rank, in-process: the tracer's consumer thread pushes live
    snapshots; after stop the master composite equals tally_trace."""
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import tally_trace

    d = str(tmp_path / "t")
    with MasterServer(port=0) as m:
        cfg = TraceConfig(out_dir=d, mode="default", stream_to=m.addr, stream_period_s=0.05)
        assert cfg.online  # streaming implies the live tally
        with Tracer(cfg) as tr:
            _traced_steps(5, "inc_sum", pause_s=0.03)
        assert tr.handle.streamed >= 1  # final push is unconditional
        live, _ = fetch_composite(m.addr)
    offline = tally_trace(d)
    assert totals(live) == totals(offline)
    assert live.hostnames == offline.hostnames


def test_tracer_serve_port_mid_run_attach(tmp_path):
    """serve_port runs an in-process master: a client can attach mid-run and
    see the live profile of the traced process."""
    from repro_torch.core import TraceConfig, Tracer, live_snapshot

    d = str(tmp_path / "t")
    cfg = TraceConfig(out_dir=d, mode="default", serve_port=0, stream_period_s=0.02)
    with Tracer(cfg) as tr:
        key = ("ust_repro", "decode_step")
        _traced_steps(4, "dbl_sum")
        assert wait_until(
            lambda: fetch_composite(f"127.0.0.1:{tr.server.port}")[0].apis.get(key)
            is not None
        )
        assert live_snapshot() is not None  # serve-layer hook sees it too
    assert live_snapshot() is None  # session over


# ---------------------------------------------------------------------------
# Wire parity with the JAX package: ranks of either package stream into one
# master, so the frames must be the same bytes
# ---------------------------------------------------------------------------

PACKAGES = {
    "torch": (torch_stream, Tally, ApiStat),
    "jax": (jax_stream, JaxTally, JaxApiStat),
}


def mk_pkg_tally(pkg: str, rank: int, calls: int, wide: int = 0):
    """``mk_tally`` built from ``pkg``'s own Tally/ApiStat, plus ``wide``
    extra runtime rows."""
    _, tally_cls, stat_cls = PACKAGES[pkg]
    t = tally_cls()
    t.hostnames.add(f"node{rank // 8:03d}")
    t.processes.add(rank)
    t.threads.add((rank, 1))
    st = stat_cls()
    for i in range(calls):
        st.add(1000 + rank + i)
    t.apis[("ust_repro", "decode_step")] = st
    s2 = stat_cls()
    s2.add(50 * (rank + 1))
    t.device_apis[("ust_kernel", "flash_attention")] = s2
    for i in range(wide):
        s3 = stat_cls()
        s3.add(10 + i)
        t.apis[("ust_torchrt", f"cold_{i}")] = s3
    return t


def test_protocol_versions_are_equal():
    assert torch_stream.PROTOCOL_VERSION == jax_stream.PROTOCOL_VERSION == 2
    assert torch_stream.DELTA_MIN_VERSION == jax_stream.DELTA_MIN_VERSION
    assert torch_stream.MAX_FRAME == jax_stream.MAX_FRAME


def _messages(pkg: str) -> list:
    older = mk_pkg_tally(pkg, 3, calls=4, wide=20)
    newer = mk_pkg_tally(pkg, 3, calls=7, wide=20)
    newer.hostnames.add("node999")
    return [
        {"type": "hello", "v": 2, "source": "host:1:rank3", "token": "t", "incarnation": 2},
        {"type": "snapshot", "v": 2, "source": "host:1:rank3", "seq": 0, "ts": 1.5,
         "tally": older.to_obj(), "telemetry": {"mem_in_use": 1 << 30, "host_rss": 7}},
        {"type": "delta", "v": 2, "source": "host:1:rank3", "seq": 1, "base_seq": 0, "ts": 2.5,
         "delta": newer.delta_to(older)},
        {"type": "composite", "v": 2, "tally": newer.to_obj()},
    ]


def test_pack_frame_gives_the_jax_packages_bytes():
    """The same messages, full and delta, each built from its package's own
    tally, frame to the same bytes; and each package reads the other's."""
    mine, theirs = _messages("torch"), _messages("jax")
    assert mine == theirs
    for m, j in zip(mine, theirs):
        assert torch_stream.pack_frame(m) == jax_stream.pack_frame(j)
    a, b = socket.socketpair()
    try:
        for m in mine:
            a.sendall(torch_stream.pack_frame(m))
        assert [jax_stream.recv_frame(b) for _ in mine] == theirs
        for j in theirs:
            b.sendall(jax_stream.pack_frame(j))
        assert [torch_stream.recv_frame(a) for _ in theirs] == mine
    finally:
        a.close()
        b.close()


def _raw_frame(conn) -> bytes:
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            assert chunk, "streamer closed the connection"
            buf += chunk
        return buf

    hdr = exact(4)
    return hdr + exact(int.from_bytes(hdr, "big"))


def _wire_of(pkg: str) -> list:
    """The raw frames a ``pkg`` SnapshotStreamer sends for a full snapshot
    and two deltas (hello, snapshot, hello_ack from the peer, delta, delta)."""
    stream_mod = PACKAGES[pkg][0]
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    s = stream_mod.SnapshotStreamer(f"127.0.0.1:{srv.getsockname()[1]}", source="host:1:rank0")
    conn = None
    try:
        assert s.push(mk_pkg_tally(pkg, 0, calls=3, wide=8))
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        frames = [_raw_frame(conn), _raw_frame(conn)]
        conn.sendall(stream_mod.pack_frame({"type": "hello_ack", "v": 2, "tenant": "default"}))
        assert wait_until(lambda: (s.poll_control() or True) and s.peer_version == 2)
        for calls in (5, 9):
            assert s.push(mk_pkg_tally(pkg, 0, calls=calls, wide=8))
            frames.append(_raw_frame(conn))
        assert s.full_frames == 1 and s.delta_frames == 2
        return frames
    finally:
        s.close()
        if conn is not None:
            conn.close()
        srv.close()


def test_streamer_sends_the_jax_streamers_bytes(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)  # the frames' "ts"
    mine, theirs = _wire_of("torch"), _wire_of("jax")
    assert len(mine) == 4
    assert mine == theirs


@pytest.mark.parametrize("streamer_pkg,master_pkg", [("torch", "jax"), ("jax", "torch")])
def test_a_composite_streamed_across_the_packages_equals_its_source(streamer_pkg, master_pkg):
    """A streamer of one package pushes full and delta frames into a master of
    the other: the composite equals the pushed tally, per API."""
    s_mod, m_mod = PACKAGES[streamer_pkg][0], PACKAGES[master_pkg][0]
    with m_mod.MasterServer(port=0) as m:
        s = s_mod.SnapshotStreamer(m.addr, source="host:1:rank0")
        try:
            assert s.push(mk_pkg_tally(streamer_pkg, 0, calls=3, wide=8))
            assert wait_until(lambda: (s.poll_control() or True) and s.peer_version == 2)
            last = None
            for calls in (5, 9, 12):
                last = mk_pkg_tally(streamer_pkg, 0, calls=calls, wide=8)
                assert s.push(last)
            assert s.delta_frames >= 2
            want = totals(last)
            assert wait_until(lambda: totals(m.composite()) == want)
            with m_mod.StreamClient(m.addr) as c:
                got, meta = c.composite()
            assert totals(got) == want and meta["sources"] == 1
            assert got.hostnames == last.hostnames and got.threads == last.threads
            assert m.stats()["deltas"] >= 2
        finally:
            s.close()
