"""The port's streaming failure paths, the twin of the stream cases of
``tests/test_resilience.py`` against ``repro_torch.core``: daemon survival,
late masters, and telemetry forwarding (the checkpoint cases' twins are in
``test_torch_checkpoint.py``).  Then the telemetry a traced session
streams: the port's device-memory figures reach the master, from the inline
reading and from the sampling daemon."""

import socket
import threading
import time

import numpy as np
import pytest

from repro_torch.core.plugins.tally import ApiStat, Tally
from repro_torch.core.stream import MasterServer, SnapshotStreamer, StreamClient
from repro_torch.core.telemetry import TelemetryDaemon

TELEMETRY_KEYS = {"mem_in_use", "mem_peak", "mem_limit", "host_rss", "step_rate", "memcpy_bw",
                  "alloc_bw"}


def mk_tally(ns=1000):
    t = Tally()
    st = ApiStat()
    st.add(ns)
    t.apis[("ust_repro", "decode_step")] = st
    return t


# ---------------------------------------------------------------------------
# telemetry daemon survives bad samples
# ---------------------------------------------------------------------------


def test_daemon_survives_failing_sample():
    calls = {"n": 0}

    def record(*a):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise OSError("transient /proc failure")

    d = TelemetryDaemon(record, period_s=0.005)
    d.start()
    deadline = time.monotonic() + 5.0
    while (d.sample_errors < 3 or d.samples < 2) and time.monotonic() < deadline:
        time.sleep(0.01)
    d.stop()
    assert d.sample_errors >= 3  # failures counted...
    assert d.samples >= 2  # ...and the loop kept sampling afterwards
    assert d.last  # the good samples refreshed the snapshot


# ---------------------------------------------------------------------------
# streamer initial-connect retry
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_streamer_default_is_fail_fast():
    sr = SnapshotStreamer(("127.0.0.1", _free_port()), "r0", timeout_s=0.5)
    t0 = time.monotonic()
    assert sr.push(mk_tally()) is False
    assert time.monotonic() - t0 < 2.0
    assert sr.dropped == 1
    sr.close()


def test_streamer_retries_until_master_arrives():
    port = _free_port()
    box = {}

    def late_master():
        time.sleep(0.4)
        box["master"] = MasterServer(port=port).start()

    th = threading.Thread(target=late_master, daemon=True)
    th.start()
    sr = SnapshotStreamer(
        ("127.0.0.1", port), "r0", connect_retries=40, connect_backoff_s=0.05
    )
    try:
        assert sr.push(mk_tally()) is True  # blocked through the gap, then landed
        th.join()
        deadline = time.monotonic() + 5.0
        while "r0" not in box["master"].ranks() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "r0" in box["master"].ranks()
    finally:
        sr.close()
        th.join()
        box["master"].stop()


def test_streamer_rejects_bad_retry_params():
    with pytest.raises(ValueError):
        SnapshotStreamer(("127.0.0.1", 1), "r0", connect_retries=-1)
    with pytest.raises(ValueError):
        SnapshotStreamer(("127.0.0.1", 1), "r0", connect_backoff_s=0.0)


# ---------------------------------------------------------------------------
# telemetry forwarding: submit → master.telemetry() → StreamClient meta
# ---------------------------------------------------------------------------


def test_telemetry_rides_frames_end_to_end():
    master = MasterServer(port=0).start()
    try:
        telem = {"mem_in_use": 9, "mem_limit": 100, "host_rss": 1234}
        master.submit("rank0", mk_tally(), telemetry=telem)
        master.submit("rank1", mk_tally())
        assert master.telemetry() == {"rank0": telem}
        ranks, meta = StreamClient(master.addr).ranks()
        assert set(ranks) == {"rank0", "rank1"}
        assert meta["telemetry"]["rank0"]["host_rss"] == 1234
        assert "rank1" not in meta["telemetry"]
    finally:
        master.stop()


def test_telemetry_push_is_never_elided():
    master = MasterServer(port=0).start()
    sr = SnapshotStreamer(master.addr, "r0")
    try:
        t = mk_tally()
        assert sr.push(t, skip_unchanged=True)
        deadline = time.monotonic() + 5.0
        while sr.peer_version is None and time.monotonic() < deadline:
            sr.poll_control()  # deltas (and elision) start after hello_ack
            time.sleep(0.02)
        assert sr.push(t, skip_unchanged=True)  # unchanged → elided
        assert sr.skipped == 1
        assert sr.push(t, skip_unchanged=True, telemetry={"host_rss": 7})
        assert sr.skipped == 1  # telemetry forces the frame out
        deadline = time.monotonic() + 5.0
        while not master.telemetry() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert master.telemetry().get("r0") == {"host_rss": 7}
    finally:
        sr.close()
        master.stop()


# ---------------------------------------------------------------------------
# a traced session's telemetry reaches its master
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sample,sample_period_s,keys",
    [
        (False, 0.01, TELEMETRY_KEYS),
        (True, 0.01, TELEMETRY_KEYS | {"cpu_pct"}),
        (True, 3600.0, {"mem_in_use", "mem_peak", "mem_limit", "host_rss"}),
    ],
    ids=["inline", "daemon", "daemon-before-its-first-sample"],
)
def test_session_streams_its_device_telemetry(tmp_path, sample, sample_period_s, keys):
    """The in-process master holds this rank's telemetry dict: the device
    memory figures (0 on the CPU, the caching allocator's on the card), host
    RSS and the transfer rates; with ``sample`` the daemon's latest sample,
    and before the daemon's first sample the memory figures and host RSS
    read inline (a session shorter than one sample period)."""
    from repro_torch.core import TraceConfig, Tracer, traced_device_put

    cfg = TraceConfig(out_dir=str(tmp_path / "t"), serve_port=0, sample=sample,
                      stream_period_s=0.02, flush_period_s=0.01,
                      sample_period_s=sample_period_s)
    with Tracer(cfg) as tr:
        traced_device_put(np.arange(256, dtype=np.float32), "cpu")
        deadline = time.monotonic() + 5.0
        while not keys <= set(next(iter(tr.server.telemetry().values()), {})):
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        # the session keeps pushing (host RSS moves between pushes): read the
        # master and a client's query until no push fell between the two
        deadline = time.monotonic() + 5.0
        with StreamClient(tr.server.addr) as client:
            while True:
                (src, telem), = tr.server.telemetry().items()
                ranks, meta = client.ranks()
                if meta["telemetry"][src] == telem or time.monotonic() > deadline:
                    break
    assert src == tr._stream_source and set(ranks) == {src}
    assert set(telem) == keys
    assert telem["host_rss"] > 0
    assert (telem["mem_in_use"], telem["mem_peak"], telem["mem_limit"]) == (0, 0, 0)
    assert meta["telemetry"][src]["host_rss"] == telem["host_rss"]
