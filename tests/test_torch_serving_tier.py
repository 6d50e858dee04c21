"""The port's hardened serving tier, the twin of ``tests/test_serving_tier.py``
against ``repro_torch.core.{stream,iprof}``: token auth, TLS, per-tenant
namespaces + quotas, the shared broadcast hub (encode-once fanout,
slow-subscriber eviction), the unified StreamClient, ``iprof top --live``
reconnect across a master restart, and the CLI over TLS, whose ``iprof run``
launches the port's serving entry point on the CPU."""

import os
import re
import select
import socket
import subprocess
import sys
import threading
import time

import pytest

from repro_torch.core.iprof import main as iprof_main
from repro_torch.core.plugins.tally import ApiStat, Tally
from repro_torch.core.stream import (
    MasterServer,
    PROTOCOL_VERSION,
    ProtocolError,
    ServeOptions,
    ServerRejected,
    SnapshotStreamer,
    StreamClient,
    client_ssl_context,
    pack_frame,
    parse_addr,
    recv_frame,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mk_tally(rank: int, calls: int = 10, ns: int = 1000) -> Tally:
    t = Tally()
    t.hostnames.add(f"node{rank // 8:03d}")
    t.processes.add(rank)
    t.threads.add((rank, 1))
    st = ApiStat()
    for _ in range(calls):
        st.add(ns)
    t.apis[("ust_repro", "train_step")] = st
    return t


def mk_wide_tally(rows: int, calls: int = 1) -> Tally:
    """A tally with many distinct API rows — frames big enough to clog a
    deliberately tiny receive window (the slow-subscriber test)."""
    t = Tally()
    t.processes.add(0)
    for i in range(rows):
        st = ApiStat()
        for _ in range(calls):
            st.add(1000 + i)
        t.apis[("ust_repro", f"api_{i:05d}")] = st
    return t


def wait_until(pred, timeout_s=5.0, period_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period_s)
    return pred()


def listening_port(proc, timeout_s: float) -> int:
    """The port an ``iprof serve --port 0`` subprocess prints that it
    listens on, read from its stdout within ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    seen = []
    while time.monotonic() < deadline and proc.poll() is None:
        if not select.select([proc.stdout], [], [], 0.5)[0]:
            continue
        line = proc.stdout.readline()
        seen.append(line)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            return int(m.group(1))
    raise AssertionError(f"iprof serve did not start (rc {proc.poll()}): {''.join(seen)}")


def restart_master(port: int, timeout_s: float = 10.0, **kw) -> MasterServer:
    """Start a master on a just-released port, riding out the rebind race."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return MasterServer(port=port, **kw).start()
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)


# ---------------------------------------------------------------------------
# TLS material (self-signed, generated once per session via the openssl CLI)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="session")
def tls_pair(tmp_path_factory):
    import shutil

    if shutil.which("openssl") is None:
        pytest.skip("openssl CLI not available to mint a test certificate")
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key, "-out", cert, "-days", "2", "-nodes",
            "-subj", "/CN=localhost",
        ],
        check=True,
        capture_output=True,
    )
    return cert, key


# ---------------------------------------------------------------------------
# ServeOptions
# ---------------------------------------------------------------------------


def test_serve_options_validation():
    with pytest.raises(ValueError):
        ServeOptions(tls_key="k.pem")  # key without cert
    with pytest.raises(ValueError):
        ServeOptions(tls_ca="ca.pem")  # client-cert CA without cert
    with pytest.raises(ValueError):
        ServeOptions(max_sources=-1)
    with pytest.raises(ValueError):
        ServeOptions(hub_queue_frames=0)
    assert not ServeOptions().auth_required


def test_tenant_for_constant_time_mapping():
    o = ServeOptions(auth_tokens={"ta": "alpha", "tb": "", "tc": "default"})
    assert o.auth_required
    assert o.tenant_for("ta") == "alpha"
    assert o.tenant_for("tb") == "default"  # empty tenant → default
    assert o.tenant_for("tc") == "default"
    assert o.tenant_for("nope") is None
    assert o.tenant_for(None) is None
    assert o.tenant_for(b"ta") == "alpha"  # bytes token from the wire
    assert ServeOptions().tenant_for(None) == "default"  # auth off


# ---------------------------------------------------------------------------
# Token auth
# ---------------------------------------------------------------------------


def test_bad_token_rejected():
    with MasterServer(port=0, options=ServeOptions(auth_tokens={"s3cret": ""})) as m:
        with pytest.raises(ServerRejected) as ei:
            StreamClient(m.addr, timeout_s=3.0, token="wrong").connect()
        assert ei.value.code == "auth"
        assert wait_until(lambda: m.auth_failures >= 1)


def test_missing_token_rejected():
    with MasterServer(port=0, options=ServeOptions(auth_tokens={"s3cret": ""})) as m:
        with pytest.raises(ServerRejected):
            with StreamClient(m.addr, timeout_s=3.0) as c:  # no token at all
                c.ping()
        assert m.auth_failures >= 1
        # the composite is not readable without auth either
        with pytest.raises(ServerRejected):
            StreamClient(m.addr, timeout_s=3.0, token="").connect()


def test_good_token_binds_tenant():
    opts = ServeOptions(auth_tokens={"ta": "alpha", "td": ""})
    with MasterServer(port=0, options=opts) as m:
        with StreamClient(m.addr, token="ta") as c:
            assert c.tenant == "alpha"
            assert c.server_version == PROTOCOL_VERSION
            assert c.ping()
        with StreamClient(m.addr, token="td") as c:
            assert c.tenant == "default"
        assert m.auth_failures == 0


def test_frames_before_hello_rejected_when_auth_required():
    """A client that skips hello entirely must not reach any handler."""
    with MasterServer(port=0, options=ServeOptions(auth_tokens={"t": ""})) as m:
        s = socket.create_connection(parse_addr(m.addr), timeout=3.0)
        try:
            s.sendall(pack_frame({"type": "query", "v": PROTOCOL_VERSION}))
            reply = recv_frame(s)
            assert reply is not None and reply["type"] == "error"
            assert reply["error"] == "auth"
        finally:
            s.close()
        assert wait_until(lambda: m.auth_failures >= 1)
        assert m.queries == 0


def test_streamer_rejected_on_bad_token_counts_and_drops():
    with MasterServer(port=0, options=ServeOptions(auth_tokens={"good": ""})) as m:
        s = SnapshotStreamer(m.addr, source="r0", token="bad", retry_s=0.05)
        t = mk_tally(0)
        for _ in range(30):
            s.push(t)
            s.poll_control()
            if s.rejected:
                break
            time.sleep(0.05)
        assert s.rejected >= 1
        assert len(m.ranks()) == 0  # nothing ingested
        s.close()


# ---------------------------------------------------------------------------
# Tenant isolation + quotas
# ---------------------------------------------------------------------------


def test_tenant_a_cannot_read_tenant_b():
    opts = ServeOptions(auth_tokens={"ta": "alpha", "tb": "beta"})
    with MasterServer(port=0, options=opts) as m:
        sa = SnapshotStreamer(m.addr, source="rank0", token="ta")
        sb = SnapshotStreamer(m.addr, source="rank0", token="tb")  # same id!
        ta, tb = mk_tally(0, calls=3), mk_tally(1, calls=7)
        assert sa.push(ta) and sb.push(tb)
        assert wait_until(
            lambda: len(m.ranks(tenant="alpha")) == 1
            and len(m.ranks(tenant="beta")) == 1
        )
        with StreamClient(m.addr, token="ta") as ca:
            tal, meta = ca.composite()
            assert tal.to_obj() == ta.to_obj()  # alpha sees alpha, exactly
            assert meta["sources"] == 1
            ranks, _ = ca.ranks()
            assert ranks["rank0"].to_obj() == ta.to_obj()
        with StreamClient(m.addr, token="tb") as cb:
            tal, _ = cb.composite()
            assert tal.to_obj() == tb.to_obj()  # same source id, other state
        st = m.stats()
        assert set(st["per_tenant"]) >= {"alpha", "beta"}
        assert st["per_tenant"]["alpha"]["sources"] == 1
        sa.close()
        sb.close()


def test_subscription_is_tenant_scoped():
    opts = ServeOptions(auth_tokens={"ta": "alpha", "tb": "beta"})
    with MasterServer(port=0, options=opts) as m:
        assert m.submit("r0", mk_tally(0, calls=3), tenant="alpha")
        assert m.submit("r0", mk_tally(1, calls=9), tenant="beta")
        with StreamClient(m.addr, token="ta") as c:
            tal, meta = next(iter(c.subscribe(period_s=0.05)))
            key = ("ust_repro", "train_step")
            assert tal.apis[key].calls == 3  # alpha's tally, not beta's


def test_source_quota_rejects_and_counts():
    with MasterServer(port=0, options=ServeOptions(max_sources=2)) as m:
        assert m.submit("r0", mk_tally(0))
        assert m.submit("r1", mk_tally(1))
        assert not m.submit("r2", mk_tally(2))  # over quota
        assert m.submit("r0", mk_tally(0, calls=20))  # updates still fine
        assert m.quota_src_rejects == 1
        assert len(m.ranks()) == 2
        assert m.stats()["quota_src_rejects"] == 1


def test_row_quota_rejects_full_and_delta():
    with MasterServer(port=0, options=ServeOptions(max_tally_rows=8)) as m:
        assert m.submit("r0", mk_wide_tally(4))
        assert not m.submit("r0", mk_wide_tally(50))  # grown past the cap
        assert m.quota_row_rejects == 1
        # the last admitted state is retained untouched
        assert len(m.ranks()["r0"].apis) == 4


def test_subscriber_quota_rejects_with_error_frame():
    with MasterServer(port=0, options=ServeOptions(max_subscribers=1)) as m:
        m.submit("r0", mk_tally(0))
        c1 = StreamClient(m.addr)
        gen1 = c1.subscribe(period_s=0.05)
        next(gen1)  # first subscriber admitted and served
        assert wait_until(lambda: m.stats()["subscribers"] == 1)
        c2 = StreamClient(m.addr)
        with pytest.raises(ServerRejected) as ei:
            next(c2.subscribe(period_s=0.05))
        assert ei.value.code == "quota"
        assert m.quota_sub_rejects == 1
        gen1.close()
        c1.close()
        c2.close()
        assert wait_until(lambda: m.stats()["subscribers"] == 0)


# ---------------------------------------------------------------------------
# Broadcast hub: encode-once fanout + slow-consumer eviction
# ---------------------------------------------------------------------------


def _raw_subscribe(addr, period_s, rcvbuf=None):
    """Hand-rolled subscriber socket (so tests control draining exactly)."""
    s = socket.socket()
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    s.connect(parse_addr(addr))
    s.settimeout(5.0)
    s.sendall(pack_frame({"type": "hello", "v": PROTOCOL_VERSION, "source": "sub"}))
    ack = recv_frame(s)
    assert ack and ack["type"] == "hello_ack"
    s.sendall(
        pack_frame(
            {"type": "subscribe", "v": PROTOCOL_VERSION, "period_s": period_s}
        )
    )
    return s


def test_fanout_encodes_once_per_update():
    """The hub invariant: N subscribers share one serialization per update —
    ``sub_encodes`` tracks updates, not subscriber count."""
    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0))
        subs = [_raw_subscribe(m.addr, 0.02) for _ in range(8)]
        try:
            # each subscriber gets its snapshot-on-join full frame
            for s in subs:
                msg = recv_frame(s)
                assert msg["type"] == "composite" and "tally" in msg
            base = m.sub_encodes
            n_updates = 5
            got_full = [1] * len(subs)
            for u in range(n_updates):
                m.submit("r0", mk_tally(0, calls=20 + u))
                deadline = time.monotonic() + 5.0
                # every subscriber sees this update before the next lands
                for i, s in enumerate(subs):
                    while time.monotonic() < deadline:
                        msg = recv_frame(s)
                        if msg["type"] == "composite" and "tally" in msg:
                            got_full[i] += 1
                            break
            assert all(n >= n_updates for n in got_full)
            # 8 subscribers, 5 updates: a per-subscriber encode would be ≥40
            assert m.sub_encodes - base <= n_updates + 2
            assert m.sub_frames >= 8 * n_updates
        finally:
            for s in subs:
                s.close()


#: how long the slow subscriber may take to be evicted, and each later wait:
#: the eviction comes once the master's socket buffers towards it are full,
#: after 35-125 wide frames on an idle host, and a loaded host's hub thread
#: coalesces submits, so it takes more of them; the waits end as soon as
#: their condition holds
EVICTION_DEADLINE_S = 60.0
WAIT_S = 30.0


def test_slow_subscriber_evicted_without_stalling_hub():
    """A subscriber that never drains gets evicted on queue overflow; the
    healthy subscriber next to it keeps receiving throughout.  Every wait
    runs to a deadline, not a count of submits."""
    opts = ServeOptions(hub_queue_frames=2)
    with MasterServer(port=0, options=opts) as m:
        wide = mk_wide_tally(1500)  # ~100 KB frames: clogs a 4 KB window fast
        m.submit("r0", wide)
        slow = _raw_subscribe(m.addr, 0.01, rcvbuf=4096)
        healthy = _raw_subscribe(m.addr, 0.01)
        try:
            assert recv_frame(healthy)["type"] == "composite"
            healthy_frames = 0
            deadline = time.monotonic() + EVICTION_DEADLINE_S
            i = 0
            while m.sub_evictions < 1 and time.monotonic() < deadline:
                wide.apis[("ust_repro", "api_00000")].add(1000 + i)
                i += 1
                m.submit("r0", wide)
                r, _, _ = select.select([healthy], [], [], 0.05)
                if r:
                    recv_frame(healthy)
                    healthy_frames += 1
            assert m.sub_evictions >= 1, "slow subscriber was never evicted"
            # hub still alive for the healthy subscriber after the eviction
            m.submit("r0", mk_wide_tally(1500, calls=3))
            assert wait_until(
                lambda: select.select([healthy], [], [], 0.1)[0] != [], timeout_s=WAIT_S
            )
            assert recv_frame(healthy)["type"] == "composite"
            assert healthy_frames >= 1
        finally:
            slow.close()
            healthy.close()
        assert wait_until(lambda: m.stats()["subscribers"] == 0, timeout_s=WAIT_S)


# ---------------------------------------------------------------------------
# TLS
# ---------------------------------------------------------------------------


def test_tls_end_to_end_streamer_and_client(tls_pair):
    cert, key = tls_pair
    opts = ServeOptions(tls_cert=cert, tls_key=key, auth_tokens={"tok": ""})
    with MasterServer(port=0, options=opts) as m:
        s = SnapshotStreamer(
            m.addr,
            source="r0",
            token="tok",
            ssl_context=client_ssl_context(cafile=cert),
        )
        t = mk_tally(0, calls=4)
        assert s.push(t)
        assert wait_until(lambda: len(m.ranks()) == 1)
        with StreamClient(m.addr, token="tok", tls_ca=cert) as c:
            tal, meta = c.composite()
            assert tal.to_obj() == t.to_obj()
            assert m.stats()["tls"] is True
        s.close()
        assert m.tls_failures == 0


@pytest.mark.parametrize("tls", [False, True], ids=["tcp", "tls"])
def test_single_push_then_close_lands(tls, tls_pair):
    """A session that pushes once and closes (a short run's only, final
    push) must land. Closing with the master's hello_ack or TLS session
    tickets unread made the kernel reset the connection, and over TLS the
    master lost most such pushes before ``close`` read to its EOF."""
    cert, key = tls_pair
    opts = ServeOptions(tls_cert=cert, tls_key=key) if tls else ServeOptions()
    kw = {"ssl_context": client_ssl_context(cafile=cert)} if tls else {}
    sessions = 24
    with MasterServer(port=0, options=opts) as m:
        for i in range(sessions):
            s = SnapshotStreamer(m.addr, source=f"r{i}", **kw)
            assert s.push(mk_tally(i, calls=i + 1))
            s.close()
        assert wait_until(lambda: len(m.ranks()) == sessions, timeout_s=10.0)
        tal, _ = StreamClient(m.addr, tls_ca=cert if tls else None).composite()
        assert tal.apis[("ust_repro", "train_step")].calls == sum(range(1, sessions + 1))


def test_tls_client_against_plaintext_server_fails_cleanly():
    """A TLS client hitting a plaintext master must get a prompt, clean
    error (the ClientHello reads as an oversized frame server-side), never
    a hang."""
    with MasterServer(port=0) as m:
        t0 = time.monotonic()
        with pytest.raises((OSError, ProtocolError)):
            StreamClient(m.addr, timeout_s=3.0, tls_ca=__file__).connect()
        assert time.monotonic() - t0 < 5.0


def test_plaintext_client_against_tls_server_fails_cleanly(tls_pair):
    cert, key = tls_pair
    with MasterServer(port=0, options=ServeOptions(tls_cert=cert, tls_key=key)) as m:
        t0 = time.monotonic()
        with pytest.raises((OSError, ProtocolError)):
            StreamClient(m.addr, timeout_s=3.0).connect()  # no TLS
        assert time.monotonic() - t0 < 10.0
        assert wait_until(lambda: m.tls_failures >= 1)


# ---------------------------------------------------------------------------
# StreamClient ergonomics + deprecated shims
# ---------------------------------------------------------------------------


def test_stream_client_reuses_one_connection():
    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0))
        with StreamClient(m.addr) as c:
            for _ in range(5):
                c.composite()
                c.ranks()
                c.groups()
            c.ping()
        assert m.queries >= 15  # 16 requests over one pooled connection


def test_stream_client_transparent_reconnect_after_restart():
    """A pooled connection that died (master restart) is retried once."""
    m1 = MasterServer(port=0).start()
    port = m1.port
    m1.submit("r0", mk_tally(0))
    c = StreamClient(f"127.0.0.1:{port}")
    tal, _ = c.composite()
    assert tal.apis
    m1.stop()
    m2 = restart_master(port)
    try:
        m2.submit("r0", mk_tally(0, calls=2))
        tal, _ = c.composite()  # pooled conn is dead: reconnects, succeeds
        assert tal.apis[("ust_repro", "train_step")].calls == 2
    finally:
        c.close()
        m2.stop()


def test_deprecated_query_helpers_still_work_and_warn():
    from repro_torch.core.stream import query_composite, query_ranks

    with MasterServer(port=0) as m:
        m.submit("r0", mk_tally(0, calls=6))
        with pytest.warns(DeprecationWarning):
            t, meta = query_composite(m.addr)
        assert t.apis[("ust_repro", "train_step")].calls == 6
        with pytest.warns(DeprecationWarning):
            ranks, _ = query_ranks(m.addr)
        assert set(ranks) == {"r0"}


# ---------------------------------------------------------------------------
# iprof top --live reconnect
# ---------------------------------------------------------------------------


def test_top_live_reconnects_across_master_restart(capsys):
    m1 = MasterServer(port=0).start()
    port = m1.port
    m1.submit("r0", mk_tally(0))
    rc = {}

    def run_top():
        rc["rc"] = iprof_main(
            [
                "top",
                f"127.0.0.1:{port}",
                "--live",
                "--iterations",
                "6",
                "--interval",
                "0.2",
                "--no-clear",
            ]
        )

    th = threading.Thread(target=run_top, daemon=True)
    th.start()
    assert wait_until(lambda: m1.stats()["subscribers"] == 1)
    m1.submit("r0", mk_tally(0, calls=20))
    time.sleep(0.3)  # let a couple of frames render
    m1.stop()  # master restart: the old loop would die here with rc 1
    m2 = restart_master(port)
    try:
        assert wait_until(lambda: m2.stats()["subscribers"] == 1, timeout_s=15.0)
        for i in range(10):
            m2.submit("r0", mk_tally(0, calls=30 + i))
            time.sleep(0.1)
            if not th.is_alive():
                break
        th.join(timeout=30.0)
        assert not th.is_alive()
        assert rc.get("rc") == 0
    finally:
        m2.stop()


def test_top_unreachable_master_still_rc1(capsys):
    # a port bound and never listened on: connections to it are refused,
    # and no other process can take it while the test holds it
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        port = held.getsockname()[1]
        rc = iprof_main(
            ["top", f"127.0.0.1:{port}", "--live", "--iterations", "1"]
        )
    assert rc == 1
    assert "unreachable" in capsys.readouterr().err


def test_top_bad_token_rc1_no_retry_loop(capsys):
    with MasterServer(port=0, options=ServeOptions(auth_tokens={"t": ""})) as m:
        t0 = time.monotonic()
        rc = iprof_main(
            [
                "top",
                f"127.0.0.1:{m.port}",
                "--live",
                "--iterations",
                "1",
                "--token",
                "wrong",
            ]
        )
        assert rc == 1
        assert time.monotonic() - t0 < 5.0  # rejected, not retried forever
        assert "rejected" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Full CLI over TLS (serve → run --stream-to → top), subprocess e2e
# ---------------------------------------------------------------------------


def test_iprof_cli_tls_auth_end_to_end(tmp_path, tls_pair):
    cert, key = tls_pair
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    iprof = [sys.executable, "-m", "repro_torch.core.iprof"]
    serve = subprocess.Popen(
        iprof
        + [
            "serve",
            "--port",
            "0",
            "--tls-cert",
            cert,
            "--tls-key",
            key,
            "--token",
            "s3cret",
            "--duration",
            "120",
        ],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        port = listening_port(serve, timeout_s=30.0)
        run = subprocess.run(
            iprof
            + [
                "run",
                "-o",
                str(tmp_path / "t"),
                "--stream-to",
                f"127.0.0.1:{port}",
                "--stream-period",
                "0.1",
                "--token",
                "s3cret",
                "--tls-ca",
                cert,
                "--",
                "repro_torch.launch.serve:main",
                "--device",
                "cpu",
                "--requests",
                "2",
                "--new-tokens",
                "3",
            ],
            env=env,
            capture_output=True,
            text=True,
            timeout=180,
            cwd=REPO_ROOT,
        )
        assert run.returncode == 0, run.stdout + run.stderr
        assert "streamed=" in run.stdout
        top = subprocess.run(
            iprof
            + [
                "top",
                f"127.0.0.1:{port}",
                "--iterations",
                "1",
                "--no-clear",
                "--token",
                "s3cret",
                "--tls-ca",
                cert,
            ],
            env=env,
            capture_output=True,
            text=True,
            timeout=60,
        )
        assert top.returncode == 0, top.stdout + top.stderr
        assert "decode_step" in top.stdout
        # and without credentials the same master turns the client away
        bad = subprocess.run(
            iprof + ["top", f"127.0.0.1:{port}", "--iterations", "1"],
            env=env,
            capture_output=True,
            text=True,
            timeout=60,
        )
        assert bad.returncode == 1
    finally:
        serve.terminate()
        serve.wait(timeout=30)
