"""Live streaming multi-rank aggregation (THAPI §3.7 joined with §6).

The offline path (aggregate.py) is a *batch* tree reduction over ``.tally``
files; the online path (online.py) is a *single-process* live tally.  This
module joins them into a streaming service — the network-transported,
always-current version of ``aggregate_tree``:

    rank (OnlineAnalyzer) ──snapshot/delta──▶ local master ──composite──▶ global master
                                                   ▲                          ▲
                                              iprof top                  iprof top

  * Each traced rank periodically pushes its cumulative tally over TCP to a
    master (:class:`SnapshotStreamer`, driven by the tracer's consumer
    thread).  Protocol **v2** ships *delta frames* in steady state: only the
    ApiStats entries that changed since the last delivered state (each with
    its full cumulative value), with periodic full-snapshot resync frames
    bounding drift.  On very wide tallies this is the difference between
    shipping the whole table every interval and shipping a few hot rows.
  * A :class:`MasterServer` keeps the latest cumulative tally per source —
    rebuilt incrementally from deltas — and merges them with the tally
    monoid on demand.  Snapshots are cumulative, so latest-wins merging is
    idempotent and converges to exactly the offline ``combine_aggregates``
    result once every rank has pushed its final state (tracer stop pushes a
    final frame unconditionally).
  * Masters compose into a configurable-fanout tree: a master constructed
    with ``forward_to=`` periodically pushes its state upstream, exactly the
    paper's "each local master sends its aggregate to the global master" —
    but live, while the ranks still run.  Forwarded state is delta-encoded
    too, and (by default) **per rank**: every origin source rides its own
    multiplexed frame chain, so the per-rank breakdown survives each hop of
    the tree instead of collapsing into an anonymous composite.
  * ``iprof serve`` runs a master; ``iprof top`` attaches to any master and
    renders the refreshing composite (``--live`` subscribes for pushed
    updates instead of polling, ``--by-rank`` adds the per-rank table);
    :func:`query_composite` / :func:`query_ranks` /
    :func:`subscribe_composites` are the programmatic clients.  Cluster-
    scope adaptive policies (``core/adaptive.py``) read the per-rank map to
    detect stragglers and rank skew the merged composite hides.

Transport is deliberately tiny: length-prefixed msgpack frames (4-byte
big-endian length + body), one dict message per frame, ``type`` key selects
the handler.  Snapshots are kilobytes (§3.7), so a 64 MiB frame cap is
generous headroom, not a tuning knob.

Delta correctness contract (see docs/streaming.md for the full spec):

  * every frame carries ``seq``; delta frames also carry ``base_seq`` — the
    seq of the state they were computed against.  A master applies a delta
    only when its stored seq for the source equals ``base_seq``; otherwise
    it drops the frame and answers ``resync`` on the same connection, and
    the streamer's next push is a full snapshot.
  * a streamer only sends deltas after the master's ``hello_ack`` proves the
    peer speaks v2 — unknown or v1 masters receive full snapshots forever,
    so the wire stays backward compatible.
  * any reconnect starts with a full snapshot (the delta base is
    connection-local state).

This is the port's own copy of the JAX package's streaming module, with the
same names.  The wire format is the same byte for byte (``PROTOCOL_VERSION``,
field names, the delta/resync schema), so ranks of either package stream into
one master, as a mixed deployment does while it migrates.

Failure model: the traced application must never block or crash because a
master is slow, absent, or restarting.  The streamer connects lazily,
retries with backoff, and *drops* frames it cannot deliver (counted in
``dropped``) — the next successful full push carries the entire cumulative
state, so nothing is lost but latency.
"""

from __future__ import annotations

import collections
import dataclasses
import hmac
import logging
import os
import select
import socket
import ssl
import struct
import threading
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import msgpack

from .aggregate import merge_tallies
from .plugins.tally import ApiStat, Tally, intern_key

#: v2 adds delta frames, ``hello_ack`` and ``resync`` control frames, and
#: ``subscribe`` push mode. v1 peers are still understood (full snapshots).
PROTOCOL_VERSION = 2
#: oldest peer version that accepts ``delta`` frames
DELTA_MIN_VERSION = 2
MAX_FRAME = 64 << 20  # frames are tally snapshots: KBs in practice (§3.7)
_HDR = struct.Struct("!I")
#: tenant id used when auth is off, and for tokens mapped without a tenant
DEFAULT_TENANT = "default"

logger = logging.getLogger("repro_torch.stream")


class ProtocolError(RuntimeError):
    """Malformed or truncated frame on a stream connection."""


class ServerRejected(ProtocolError):
    """The server refused the request: auth failure or quota exceeded.

    Carries the server's ``error`` code (``"auth"`` / ``"quota"`` /
    ``"fence"``) so clients can distinguish retryable transport trouble from
    a hard rejection."""

    def __init__(self, code: str, detail: str = ""):
        super().__init__(f"server rejected request ({code}): {detail or code}")
        self.code = code
        self.detail = detail


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def pack_frame(msg: dict) -> bytes:
    """One message → one length-prefixed msgpack frame."""
    body = msgpack.packb(msg, use_bin_type=True)
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds cap {MAX_FRAME}")
    return _HDR.pack(len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """Read one frame; None on clean EOF, ProtocolError on a torn frame."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ProtocolError(f"peer announced {n}-byte frame (cap {MAX_FRAME})")
    body = _recv_exact(sock, n)
    if body is None:
        raise ProtocolError("connection closed mid-frame")
    return msgpack.unpackb(body, raw=False)


def parse_addr(addr: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    """``"host:port"`` / ``":port"`` / ``(host, port)`` → ``(host, port)``."""
    if isinstance(addr, tuple):
        return addr[0], int(addr[1])
    host, _, port = addr.rpartition(":")
    return (host or "127.0.0.1"), int(port)


def default_source(rank: int = 0) -> str:
    """Canonical source id for a traced rank: ``host:pid:rankN``."""
    return f"{socket.gethostname()}:{os.getpid()}:rank{rank}"


# ---------------------------------------------------------------------------
# Hardened serving tier: TLS contexts, token auth, tenants, quotas
# ---------------------------------------------------------------------------


def server_ssl_context(
    certfile: str, keyfile: Optional[str] = None, cafile: Optional[str] = None
) -> ssl.SSLContext:
    """Server-side TLS context for a master.

    ``cafile`` additionally demands client certificates signed by that CA
    (mutual TLS); without it any client may connect and token auth is the
    identity layer."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    if cafile:
        ctx.load_verify_locations(cafile)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(
    cafile: Optional[str] = None,
    certfile: Optional[str] = None,
    keyfile: Optional[str] = None,
) -> ssl.SSLContext:
    """Client-side TLS context for streamers and :class:`StreamClient`.

    ``cafile`` pins the master's (typically self-signed or fleet-internal)
    CA; without it the system trust store applies.  Hostname checking is
    disabled — masters live on ephemeral ports behind job schedulers, so
    identity comes from the pinned CA (and tokens), not DNS names."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    if cafile:
        ctx.load_verify_locations(cafile)
    else:
        ctx.load_default_certs()
    if certfile:
        ctx.load_cert_chain(certfile, keyfile)
    return ctx


@dataclasses.dataclass
class ServeOptions:
    """Every serving-tier knob for a :class:`MasterServer` in one object.

    Shared by ``MasterServer``, ``ServeEngine``, ``TraceConfig`` and the
    ``iprof serve`` flag parser, so server construction is one value instead
    of ~10 scattered keywords.  All fields have working defaults: a default-
    constructed ``ServeOptions()`` reproduces the historical open,
    plaintext, single-tenant master.

    Security knobs:

    * ``tls_cert``/``tls_key`` enable TLS on the listening socket;
      ``tls_ca`` additionally requires client certificates (mutual TLS).
    * ``auth_tokens`` maps bearer token → tenant id.  When set, every
      connection must open with a ``hello`` carrying a valid ``token``
      before any other frame; failures are rejected, logged, and counted.
      When ``None``, auth is off and every connection lands in the
      ``"default"`` tenant.
    * quotas (``max_sources``, ``max_tally_rows``, ``max_subscribers``) are
      enforced per tenant at ingest and subscribe time; ``0`` = unlimited.

    Forwarding credentials (``forward_token``/``forward_tls_ca``) are what
    *this* master presents upstream; ``forward_tenant`` names the tenant
    whose state is forwarded (interior tree hops are single-tenant
    infrastructure — see docs/streaming.md §tenants).
    """

    fanout: int = 32
    forward_ranks: bool = True
    forward_delta: bool = True
    forward_resync_every: int = 32
    rollup_groups: Union[None, str, int, Callable[[str], str]] = None
    composite_cache: bool = True
    # -- TLS --
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None
    tls_ca: Optional[str] = None
    # -- auth / tenancy --
    auth_tokens: Optional[Dict[str, str]] = None
    # -- per-tenant quotas (0 = unlimited) --
    max_sources: int = 0
    max_tally_rows: int = 0
    max_subscribers: int = 0
    #: bounded per-subscriber frame queue; a subscriber whose queue overflows
    #: (it is not draining what the hub fans out) is evicted, not waited on
    hub_queue_frames: int = 16
    # -- upstream credentials (local masters forwarding to a parent) --
    forward_token: Optional[str] = None
    forward_tls_ca: Optional[str] = None
    forward_tenant: str = DEFAULT_TENANT
    #: initial-connect resilience of the upstream forwarder: retry the
    #: *first* connect up to N times with capped-exponential backoff
    #: (base ``connect_backoff_s``) before giving up on a push — so a local
    #: master started before its parent doesn't drop early state.  0 (the
    #: default) keeps fail-fast; reconnects after a successful connection
    #: always use the non-blocking retry pacing.
    connect_retries: int = 0
    connect_backoff_s: float = 0.25
    #: garbage-collect sources whose last frame is older than this many
    #: seconds (the sender disconnected, died, or was evicted and never
    #: replaced): their rows leave ``ranks()``, the composite, and rollup
    #: groups, and each collection bumps the ``source_gc`` counter in
    #: ``stats()``.  0 (the default) keeps every source forever — the
    #: historical behavior, and the right one for short-lived runs where
    #: the final composite must include every rank that ever pushed.
    source_ttl_s: float = 0.0

    def __post_init__(self):
        if self.tls_key and not self.tls_cert:
            raise ValueError("tls_key requires tls_cert")
        if self.tls_ca and not self.tls_cert:
            raise ValueError("tls_ca (client-cert verification) requires tls_cert")
        for name in ("max_sources", "max_tally_rows", "max_subscribers"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = unlimited)")
        if self.hub_queue_frames < 1:
            raise ValueError("hub_queue_frames must be >= 1")
        if self.connect_retries < 0:
            raise ValueError("connect_retries must be >= 0")
        if self.connect_backoff_s <= 0:
            raise ValueError("connect_backoff_s must be > 0")
        if self.source_ttl_s < 0:
            raise ValueError("source_ttl_s must be >= 0 (0 = never collect)")

    @property
    def auth_required(self) -> bool:
        return bool(self.auth_tokens)

    def tenant_for(self, token: Optional[Union[str, bytes]]) -> Optional[str]:
        """Token → tenant id; None means *rejected*.

        Compares against every configured token with
        :func:`hmac.compare_digest` (no early exit on the first mismatched
        byte, and no dict-lookup timing channel on token existence).  With
        auth off every caller maps to :data:`DEFAULT_TENANT`."""
        if not self.auth_tokens:
            return DEFAULT_TENANT
        if not isinstance(token, (str, bytes)):
            return None
        tb = token.encode() if isinstance(token, str) else token
        matched: Optional[str] = None
        for tok, tenant in self.auth_tokens.items():
            if hmac.compare_digest(tok.encode(), tb):
                matched = tenant or DEFAULT_TENANT
        return matched

    def build_server_ssl(self) -> Optional[ssl.SSLContext]:
        if self.tls_cert is None:
            return None
        return server_ssl_context(self.tls_cert, self.tls_key, self.tls_ca)

    def build_forward_ssl(self) -> Optional[ssl.SSLContext]:
        if self.forward_tls_ca is None:
            return None
        return client_ssl_context(cafile=self.forward_tls_ca)


# ---------------------------------------------------------------------------
# Rank side: snapshot push client
# ---------------------------------------------------------------------------


class _SourceState:
    """Per-source seq/delta bookkeeping on the *current* connection."""

    __slots__ = ("seq", "last_sent", "sends_since_full", "force_full")

    def __init__(self):
        self.seq = 0
        self.last_sent: Optional[Tally] = None
        self.sends_since_full = 0
        self.force_full = False


class SnapshotStreamer:
    """Pushes cumulative tally state to a master; never blocks tracing.

    Push cadence belongs to the caller (the tracer's consumer thread, a
    master's forwarder loop); ``push(tally)`` always sends — the tracer's
    stop path relies on that for the final, authoritative state.

    One streamer, one connection, **many sources**: every frame names its
    ``source``, so a local master can forward its whole per-rank breakdown
    over a single upstream connection (``push(tally, source=rank_id)`` per
    rank) — each source keeps an independent seq chain and delta base.
    Plain leaf ranks never pass ``source`` and behave exactly as before.

    With ``delta=True`` (the default) the streamer tracks the last state
    delivered per source on the current connection and ships only changed
    entries once the master's ``hello_ack`` confirms a v2 peer.  Every
    ``resync_every``-th push — and the first push of every connection — is a
    full snapshot, so a master can always rebuild from the wire alone.
    Counters: ``pushed`` / ``dropped`` / ``skipped`` (frames),
    ``full_frames`` / ``delta_frames`` (mix), ``bytes_sent`` (on-wire
    payload), ``resyncs`` (master-requested fallbacks to full).
    """

    def __init__(
        self,
        addr: Union[str, Tuple[str, int]],
        source: str,
        retry_s: float = 0.5,
        timeout_s: float = 2.0,
        delta: bool = True,
        resync_every: int = 32,
        token: Optional[str] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        server_hostname: Optional[str] = None,
        connect_retries: int = 0,
        connect_backoff_s: float = 0.25,
        incarnation: int = 0,
    ):
        self.addr = parse_addr(addr)
        self.source = source
        #: incarnation of this source's identity (elastic rank replacement:
        #: a replacement worker for the same logical rank carries a strictly
        #: larger incarnation; the master fences frames from superseded
        #: ones — docs/streaming.md §incarnations).  Rides the ``hello``
        #: and every state frame for the default source.
        if incarnation < 0:
            raise ValueError("incarnation must be >= 0")
        self.incarnation = int(incarnation)
        self.retry_s = retry_s
        self.timeout_s = timeout_s
        self.delta = delta
        self.resync_every = max(1, int(resync_every))
        #: initial-connect resilience: until the *first* connection has ever
        #: succeeded, a failed connect is retried up to ``connect_retries``
        #: times in-line with capped-exponential backoff (base
        #: ``connect_backoff_s``, doubling, capped at 8× base) — so ranks
        #: that start before their master don't drop their early pushes.
        #: The default 0 keeps the historical fail-fast behavior; once a
        #: connection has succeeded, reconnects always use the non-blocking
        #: ``retry_s`` pacing (a mid-run master outage must not stall
        #: the consumer thread).
        if connect_retries < 0 or connect_backoff_s <= 0:
            raise ValueError("connect_retries must be >= 0 and connect_backoff_s > 0")
        self.connect_retries = int(connect_retries)
        self.connect_backoff_s = connect_backoff_s
        self._ever_connected = False
        #: bearer token presented in ``hello`` (auth-enabled masters)
        self.token = token
        #: client-side TLS context (see :func:`client_ssl_context`); None
        #: keeps the plaintext wire
        self.ssl_context = ssl_context
        self.server_hostname = server_hostname or self.addr[0]
        self.pushed = 0
        self.dropped = 0
        self.skipped = 0
        self.full_frames = 0
        self.delta_frames = 0
        self.bytes_sent = 0
        self.resyncs = 0
        self.rejected = 0  # master sent an error frame (auth/quota): conn dropped
        self.fenced = 0  # master fenced this incarnation: pushing stopped for good
        self._sock: Optional[socket.socket] = None
        self._next_retry = 0.0
        self._lock = threading.Lock()
        #: per-source state on the *current* connection (reset on reconnect)
        self._src: Dict[str, _SourceState] = {}
        self._peer_version: Optional[int] = None  # learned from hello_ack

    @property
    def peer_version(self) -> Optional[int]:
        """Master's protocol version once its ``hello_ack`` arrived, else None."""
        return self._peer_version

    def poll_control(self) -> None:
        """Drain pending control frames (``hello_ack`` / ``resync``) now.

        ``push`` does this automatically before every send; callers that
        want deterministic delta engagement (benchmarks, tests) may call it
        after the first push instead of waiting for the next cadence tick.
        """
        with self._lock:
            if self._sock is not None:
                self._drain_control(self._sock)

    def push(
        self,
        tally: Union[Tally, dict],
        source: Optional[str] = None,
        skip_unchanged: bool = False,
        telemetry: Optional[dict] = None,
        incarnation: Optional[int] = None,
    ) -> bool:
        """Deliver the current cumulative ``tally``; returns delivery success.

        Chooses delta vs full per the protocol contract, never blocks beyond
        ``timeout_s``, and on any failure drops the connection (the next
        successful push is a full snapshot again).  ``source`` defaults to
        this streamer's own identity; forwarders pass each origin rank's id
        to carry the per-rank breakdown upstream.  With ``skip_unchanged``
        a delta-eligible push whose state did not change since the last
        delivery is elided (counted in ``skipped``) — used by per-rank
        forwarding so idle ranks cost no wire traffic.  ``telemetry`` is an
        optional per-source device-telemetry dict (host RSS, memory
        pressure, transfer bandwidths — docs/streaming.md) that rides the
        frame as an optional key; a push carrying telemetry is never elided
        (sick-host evidence must flow even when the tally is idle).
        ``incarnation`` overrides the streamer-level incarnation per push —
        forwarders pass each origin source's incarnation so the fence holds
        at every level of the master tree; None uses the streamer's own for
        its default source and 0 for explicitly-named ones.
        """
        cur = tally if isinstance(tally, Tally) else Tally.from_obj(tally)
        src = source if source is not None else self.source
        if incarnation is not None:
            inc = int(incarnation)
        else:
            inc = self.incarnation if source is None else 0
        with self._lock:
            sock = self._ensure_conn()
            if sock is None:
                self.dropped += 1
                return False
            if not self._drain_control(sock):
                self.dropped += 1
                return False
            st = self._src.setdefault(src, _SourceState())
            msg = self._encode(st, src, cur, skip_unchanged and telemetry is None)
            if msg is None:  # delta-eligible and nothing changed: elide
                self.skipped += 1
                return True
            if telemetry is not None:
                msg["telemetry"] = telemetry
            if inc:
                msg["incarnation"] = inc
            frame = pack_frame(msg)
            try:
                sock.sendall(frame)
            except OSError:
                self._drop_conn()
                self.dropped += 1
                return False
            st.seq += 1
            self.pushed += 1
            self.bytes_sent += len(frame)
            # keep a private copy: the caller may keep mutating its tally
            st.last_sent = Tally().merge(cur)
            if msg["type"] == "delta":
                self.delta_frames += 1
                st.sends_since_full += 1
            else:
                self.full_frames += 1
                st.sends_since_full = 0
                st.force_full = False
            return True

    def _encode(
        self, st: _SourceState, source: str, cur: Tally, skip_unchanged: bool = False
    ) -> Optional[dict]:
        """Build the frame for ``cur``: delta when the contract allows it.

        Returns None when ``skip_unchanged`` is set and a delta-eligible
        state shows no change since the last delivery.
        """
        use_delta = (
            self.delta
            and st.last_sent is not None
            and not st.force_full
            and self._peer_version is not None
            and self._peer_version >= DELTA_MIN_VERSION
            and st.sends_since_full < self.resync_every
        )
        if use_delta:
            try:
                d = cur.delta_to(st.last_sent)
            except ValueError:
                use_delta = False  # non-monotone state: full resync
        if use_delta:
            if skip_unchanged and not (
                d["apis"]
                or d["device_apis"]
                or d["hostnames"]
                or d["processes"]
                or d["threads"]
                or d["discarded"] != st.last_sent.discarded
            ):
                return None
            return {
                "type": "delta",
                "v": PROTOCOL_VERSION,
                "source": source,
                "seq": st.seq,
                "base_seq": st.seq - 1,
                "ts": time.time(),
                "delta": d,
            }
        return {
            "type": "snapshot",
            "v": PROTOCOL_VERSION,
            "source": source,
            "seq": st.seq,
            "ts": time.time(),
            "tally": cur.to_obj(),
        }

    def _drain_control(self, sock: socket.socket) -> bool:
        """Consume buffered master→streamer frames; False if the conn died."""
        while True:
            try:
                r, _, _ = select.select([sock], [], [], 0)
            except (OSError, ValueError):
                self._drop_conn()
                return False
            if not r:
                return True
            try:
                msg = recv_frame(sock)
            except (ProtocolError, OSError):
                self._drop_conn()
                return False
            if msg is None:  # EOF: master went away
                self._drop_conn()
                return False
            kind = msg.get("type")
            if kind == "hello_ack":
                self._peer_version = int(msg.get("v", 1))
            elif kind == "resync":
                # scoped to one source when the master names it; a v2.0
                # master (no source field) resyncs every chain
                src = msg.get("source")
                if src is None:
                    for st in self._src.values():
                        st.force_full = True
                else:
                    self._src.setdefault(str(src), _SourceState()).force_full = True
                self.resyncs += 1
            elif kind == "error":
                # hard rejection (bad token, quota): drop the connection and
                # let the retry backoff pace reconnects — pushes keep being
                # counted in ``dropped`` so the failure is visible, and a
                # fixed token/quota on the master side heals without restart
                self.rejected += 1
                logger.warning(
                    "master %s:%d rejected stream (%s): %s",
                    self.addr[0],
                    self.addr[1],
                    msg.get("error", "?"),
                    msg.get("detail", ""),
                )
                self._drop_conn()
                if msg.get("error") == "fence":
                    # this incarnation is superseded: a replacement took over
                    # the source identity.  Reconnecting can never succeed
                    # (the fence is monotone), so stop for good — the polite
                    # client side of zombie containment.
                    self.fenced += 1
                    self._next_retry = float("inf")
                else:
                    self._next_retry = time.monotonic() + self.retry_s
                return False
            # anything else from the master is ignorable here

    def _ensure_conn(self) -> Optional[socket.socket]:
        if self._sock is not None:
            return self._sock
        if time.monotonic() < self._next_retry:
            return None
        # initial connect only: blocking capped-exponential retry so a rank
        # that starts before its master still delivers its first push
        attempts = 0 if self._ever_connected else self.connect_retries
        while True:
            try:
                s = socket.create_connection(self.addr, timeout=self.timeout_s)
                s.settimeout(self.timeout_s)
                if self.ssl_context is not None:
                    # handshake runs under the socket timeout; a plaintext or
                    # wrong-cert master fails here (OSError) → normal retry path
                    s = self.ssl_context.wrap_socket(
                        s, server_hostname=self.server_hostname
                    )
                hello = {"type": "hello", "v": PROTOCOL_VERSION, "source": self.source}
                if self.token is not None:
                    hello["token"] = self.token
                if self.incarnation:
                    hello["incarnation"] = self.incarnation
                s.sendall(pack_frame(hello))
                break
            except OSError:
                if attempts <= 0:
                    self._next_retry = time.monotonic() + self.retry_s
                    return None
                n = self.connect_retries - attempts
                attempts -= 1
                time.sleep(min(self.connect_backoff_s * (2.0**n), 8 * self.connect_backoff_s))
        self._sock = s
        self._ever_connected = True
        # connection-local delta state starts fresh: first push is full
        self._src = {}
        self._peer_version = None
        return s

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._src = {}
        self._peer_version = None

    def close(self) -> None:
        """Send ``bye`` (best-effort), wait for the master to hang up, and
        drop the connection.

        Closing while the master's frames (``hello_ack``, TLS 1.3 session
        tickets) sit unread makes the kernel answer with a reset, and the
        master can then lose the frames it had not read yet: over TLS most
        sessions of a single push lost it.  The master hangs up after
        ``bye``, so reading to its EOF (within ``timeout_s``) means every
        frame before ``bye`` was read.
        """
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(pack_frame({"type": "bye", "source": self.source}))
                    deadline = time.monotonic() + self.timeout_s
                    while (left := deadline - time.monotonic()) > 0:
                        self._sock.settimeout(left)
                        if not self._sock.recv(65536):
                            break
                except OSError:
                    pass
                self._drop_conn()


# ---------------------------------------------------------------------------
# Incremental composite maintenance (the read-path scaling layer)
# ---------------------------------------------------------------------------
#
# Cumulative tallies only grow, so a source's old→new change can be *applied*
# to a running accumulator row-by-row instead of re-merging every source per
# read: calls/total add their difference (subtraction is exact on the
# additive fields), min/max clamp (monotone growth guarantees new.min ≤
# old.min and new.max ≥ old.max, so the clamp can never miss a tighter bound
# held by the replaced state).  A change that is NOT monotone growth — a
# restarted rank, a reset counter, a shrunk table — cannot be applied
# incrementally; the helpers detect it (before touching the accumulator) and
# the caller falls back to a full rebuild on the next read.


def _acc_row(table: Dict[Tuple[str, str], ApiStat], key, st: ApiStat) -> None:
    row = table.get(key)
    if row is None:
        table[key] = ApiStat(
            calls=st.calls, total_ns=st.total_ns, min_ns=st.min_ns, max_ns=st.max_ns
        )
    else:
        row.merge(st)


def _tally_update_ops(acc: Tally, old: Optional[Tally], new: Tally) -> Optional[int]:
    """Fold one source's old→new cumulative change into accumulator ``acc``.

    Returns the number of row-ops applied — O(changed rows), the invariant
    the composite cache is built on — or None (``acc`` untouched) when the
    change is not monotone growth and the accumulator must be rebuilt.
    Validation runs fully before the first mutation, so a None return never
    leaves ``acc`` half-updated.
    """
    ops = 0
    if old is None:
        for key, st in new.apis.items():
            _acc_row(acc.apis, key, st)
            ops += 1
        for key, st in new.device_apis.items():
            _acc_row(acc.device_apis, key, st)
            ops += 1
        acc.hostnames |= new.hostnames
        acc.processes |= new.processes
        acc.threads |= new.threads
        acc.discarded += new.discarded
        return ops
    if new.discarded < old.discarded:
        return None
    if (
        old.hostnames - new.hostnames
        or old.processes - new.processes
        or old.threads - new.threads
    ):
        return None
    changed = []
    for acc_t, old_t, new_t in (
        (acc.apis, old.apis, new.apis),
        (acc.device_apis, old.device_apis, new.device_apis),
    ):
        if len(old_t) > len(new_t) or old_t.keys() - new_t.keys():
            return None
        for key, st in new_t.items():
            ost = old_t.get(key)
            if ost is None:
                changed.append((acc_t, key, None, st))
            elif (
                st.calls != ost.calls
                or st.total_ns != ost.total_ns
                or st.min_ns != ost.min_ns
                or st.max_ns != ost.max_ns
            ):
                if (
                    st.calls < ost.calls
                    or st.total_ns < ost.total_ns
                    or st.min_ns > ost.min_ns
                    or st.max_ns < ost.max_ns
                    or key not in acc_t
                ):
                    return None
                changed.append((acc_t, key, ost, st))
    for acc_t, key, ost, st in changed:
        if ost is None:
            _acc_row(acc_t, key, st)
        else:
            row = acc_t[key]
            row.calls += st.calls - ost.calls
            row.total_ns += st.total_ns - ost.total_ns
            if st.min_ns < row.min_ns:
                row.min_ns = st.min_ns
            if st.max_ns > row.max_ns:
                row.max_ns = st.max_ns
    acc.hostnames |= new.hostnames
    acc.processes |= new.processes
    acc.threads |= new.threads
    acc.discarded += new.discarded - old.discarded
    return len(changed)


def _delta_update_ops(acc: Tally, prev: Tally, delta: dict) -> Optional[int]:
    """Apply a v2 delta frame's change to accumulator ``acc``.

    The delta already names exactly the changed rows (with full cumulative
    values), so this is O(changed) with no table scan at all — the steady-
    state ingest path.  ``prev`` is the source's stored tally *before*
    ``apply_delta`` runs.  Same None-means-rebuild contract as
    :func:`_tally_update_ops`: validation — including structural validation
    of a possibly version-skewed frame — completes before the first
    mutation, so None never leaves ``acc`` half-updated.
    """
    changed = []
    try:
        for acc_t, prev_t, rows in (
            (acc.apis, prev.apis, delta["apis"]),
            (acc.device_apis, prev.device_apis, delta["device_apis"]),
        ):
            for p, a, c, t, mn, mx in rows:
                key = intern_key(p, a)
                ost = prev_t.get(key)
                if ost is not None and (
                    c < ost.calls
                    or t < ost.total_ns
                    or mn > ost.min_ns
                    or mx < ost.max_ns
                    or key not in acc_t
                ):
                    return None
                changed.append((acc_t, key, ost, c, t, mn, mx))
        hostnames = set(delta["hostnames"])
        processes = set(delta["processes"])
        threads = {tuple(x) for x in delta["threads"]}
        nd = int(delta["discarded"])
    except (KeyError, TypeError, ValueError):
        return None  # malformed frame: rebuild rather than trust it
    if nd < prev.discarded:
        return None
    for acc_t, key, ost, c, t, mn, mx in changed:
        if ost is None:
            row = acc_t.get(key)
            if row is None:
                acc_t[key] = ApiStat(calls=c, total_ns=t, min_ns=mn, max_ns=mx)
            else:
                row.calls += c
                row.total_ns += t
                if mn < row.min_ns:
                    row.min_ns = mn
                if mx > row.max_ns:
                    row.max_ns = mx
        else:
            row = acc_t[key]
            row.calls += c - ost.calls
            row.total_ns += t - ost.total_ns
            if mn < row.min_ns:
                row.min_ns = mn
            if mx > row.max_ns:
                row.max_ns = mx
    acc.hostnames |= hostnames
    acc.processes |= processes
    acc.threads |= threads
    acc.discarded += nd - prev.discarded
    return len(changed)


# ---------------------------------------------------------------------------
# Master daemon (local or global, depending on forward_to)
# ---------------------------------------------------------------------------


class _SourceEntry:
    """One source's stored state: connection generation, seq, tally, receipt
    time.  ``gen`` scopes the seq chain to the connection that produced it —
    a reconnecting sender restarts seq at 0 on a new gen, and its full
    snapshot must not be dropped as stale against the old chain.
    ``version`` stamps every state update; ``snap`` caches a frozen copy of
    the tally at ``snap_version`` so per-rank reads refresh only the sources
    that changed since the last read (O(changed), not O(ranks × rows)).
    ``incarnation`` scopes the whole entry to one incarnation of the source
    identity (elastic replacement): a frame from a lower incarnation is
    fenced, a higher one atomically replaces the entry."""

    __slots__ = (
        "gen",
        "seq",
        "tally",
        "ts",
        "version",
        "snap",
        "snap_version",
        "telemetry",
        "incarnation",
        "retired",
    )

    def __init__(self, gen: Optional[int], seq: int, tally: Tally, ts: float):
        self.gen = gen
        self.seq = seq
        self.tally = tally
        self.ts = ts
        self.version = 0
        self.snap: Optional[Tally] = None
        self.snap_version = -1
        #: latest device-telemetry dict shipped alongside this source's
        #: frames (optional wire key; None until the first carrying frame)
        self.telemetry: Optional[dict] = None
        #: incarnation number of the sender that produced this state
        self.incarnation = 0
        #: tombstone flag: the rank was evicted (and possibly replaced) —
        #: its contribution still counts, readers render it distinctly
        self.retired = False


class _Tenant:
    """One tenant's complete namespace inside a master: sources, composite
    cache, rollup groups, subscriber count.  Everything a client can read is
    scoped here, so tenant A's queries can never observe tenant B's state —
    isolation is structural, not filtered.  All fields are guarded by the
    owning master's ``_lock``."""

    __slots__ = (
        "name",
        "latest",
        "dirty_srcs",
        "version",
        "comp",
        "comp_dirty",
        "group_tallies",
        "group_members",
        "group_dirty",
        "src_group",
        "subscribers",
    )

    def __init__(self, name: str):
        self.name = name
        #: source → stored state (gen, seq, cumulative tally, receipt time)
        self.latest: Dict[str, _SourceEntry] = {}
        #: sources updated since the last successful upstream flush
        self.dirty_srcs: set = set()
        self.version = 0  # bumped per state update; gates subscription pushes
        #: incrementally-maintained composite + rebuild flag
        self.comp: Optional[Tally] = None
        self.comp_dirty = True
        #: rollup state: group id → running tally, members, rebuild flags
        self.group_tallies: Dict[str, Tally] = {}
        self.group_members: Dict[str, set] = {}
        self.group_dirty: set = set()
        self.src_group: Dict[str, str] = {}
        #: live subscriber count (quota enforcement)
        self.subscribers = 0


class MasterServer:
    """Streaming master: latest-state-per-source store + monoid merge.

    * leaf ranks (or child masters) connect and push ``snapshot`` / ``delta``
      frames; deltas are merged into the stored cumulative state
      incrementally (a per-key replace — applying frame *k* to state *k-1*
      reproduces the sender's cumulative tally exactly);
    * a delta whose ``base_seq`` doesn't match the stored state is dropped
      and answered with ``resync`` so the sender falls back to a full
      snapshot — the composite is never built from a mis-based delta;
    * any client may send ``query`` and gets the current composite back,
      ``query_ranks`` for the per-source breakdown, or ``subscribe``
      (optionally ``by_rank``) to have composites pushed periodically;
    * with ``forward_to=`` set this is a *local* master: a forwarder thread
      periodically pushes state upstream (delta-encoded like any other
      stream), making the whole arrangement the live fanout tree of §3.7.
      With ``forward_ranks`` (the default) it forwards each origin source's
      tally on its own multiplexed frame chain, so the per-rank breakdown —
      the signal cluster-scope policies need — survives every hop of the
      tree; with ``forward_ranks=False`` it collapses to one composite
      source upstream (the v2.0 behavior: cheaper at the root, anonymous).
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        forward_to: Optional[Union[str, Tuple[str, int]]] = None,
        forward_period_s: float = 0.5,
        fanout: int = 32,
        source: Optional[str] = None,
        forward_delta: bool = True,
        forward_resync_every: int = 32,
        forward_ranks: bool = True,
        rollup_groups: Union[None, str, int, "Callable[[str], str]"] = None,
        composite_cache: bool = True,
        options: Optional[ServeOptions] = None,
    ):
        self.host = host
        self.port = port  # rebound to the real port at start()
        if options is None:
            # legacy keyword construction: fold the scattered knobs into a
            # ServeOptions so there is exactly one source of truth below
            options = ServeOptions(
                fanout=fanout,
                forward_ranks=forward_ranks,
                forward_delta=forward_delta,
                forward_resync_every=forward_resync_every,
                rollup_groups=rollup_groups,
                composite_cache=composite_cache,
            )
        self.options = options
        # mirrored views of the options (long-standing public attributes)
        self.fanout = options.fanout
        self.forward_to = forward_to
        self.forward_period_s = forward_period_s
        self.forward_delta = options.forward_delta
        self.forward_resync_every = options.forward_resync_every
        self.forward_ranks = options.forward_ranks
        #: node-level pre-aggregation (>1k-rank trees): group sources into
        #: rollup tallies maintained incrementally on ingest.  ``"host"``
        #: groups by the host part of ``host:pid:rankN`` source ids; an int N
        #: buckets rank indices N-at-a-time (``group0`` = ranks 0..N-1); a
        #: callable maps source id → group id.  None disables rollups.
        self.rollup_groups = options.rollup_groups
        #: maintain the composite incrementally on ingest (O(changed) per
        #: read).  False restores the rebuild-per-read behavior — the
        #: benchmark baseline and an escape hatch, not a recommended mode.
        self.composite_cache = options.composite_cache
        self.source = source or f"master:{socket.gethostname()}:{os.getpid()}"
        #: tenant id → complete per-tenant namespace (sources, composite
        #: cache, rollups, subscriber count); non-default tenants are
        #: created on first touch, the default one eagerly (so the
        #: `_latest` compatibility view is a lock-free read)
        self._tenants: Dict[str, _Tenant] = {DEFAULT_TENANT: _Tenant(DEFAULT_TENANT)}
        self._conn_gen = 0  # connection-generation counter (gen scope)
        self._lock = threading.Lock()
        self._dirty = False
        #: server-side TLS context (built eagerly: bad cert paths fail at
        #: construction, not on the first connection)
        self._tls = options.build_server_ssl()
        self.frames = 0
        self.snapshots = 0  # state updates ingested (full + delta)
        self.full_snapshots = 0
        self.deltas = 0
        self.resyncs_sent = 0
        self.queries = 0
        self.comp_row_ops = 0  # ApiStat row merges spent maintaining/rebuilding
        self.comp_rebuilds = 0  # full composite rebuilds (non-monotone fallback)
        self.comp_incremental = 0  # ingests applied incrementally
        # hardened-tier counters
        self.auth_failures = 0  # bad/missing token, or frames before auth
        self.tls_failures = 0  # TLS handshakes that did not complete
        self.quota_src_rejects = 0  # snapshots refused: tenant source quota
        self.quota_row_rejects = 0  # frames refused: tally row quota
        self.quota_sub_rejects = 0  # subscribes refused: subscriber quota
        # elastic-replacement counters
        self.fence_rejects = 0  # frames refused: superseded incarnation
        self.source_gc = 0  # long-dead sources collected (options.source_ttl_s)
        self._gc_next = 0.0  # next TTL sweep (throttled; guarded by _lock)
        self._lsock: Optional[socket.socket] = None
        self._stop_evt = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._forwarder: Optional[SnapshotStreamer] = None
        self._hub = _BroadcastHub(self)

    def _tenant_locked(self, name: str) -> _Tenant:
        tn = self._tenants.get(name)
        if tn is None:
            tn = self._tenants[name] = _Tenant(name)
        return tn

    @property
    def _latest(self) -> Dict[str, _SourceEntry]:
        """Default tenant's source store (single-tenant compatibility view).

        Deliberately lock-free (the default tenant always exists): callers
        that mutate it — tests simulating master-side state loss — hold
        ``m._lock`` themselves, and taking it here would deadlock them.
        """
        return self._tenants[DEFAULT_TENANT].latest

    @property
    def sub_encodes(self) -> int:
        """Composite serializations spent on subscribers (once per tenant
        per update, regardless of subscriber count — the hub invariant)."""
        return self._hub.encodes

    @property
    def sub_frames(self) -> int:
        """Frames enqueued to subscribers (encode-shared fanout)."""
        return self._hub.frames_out

    @property
    def sub_evictions(self) -> int:
        """Slow subscribers evicted on queue overflow."""
        return self._hub.evictions

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MasterServer":
        """Bind, start the acceptor (and forwarder, for local masters)."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(128)
        self._lsock = ls
        self.port = ls.getsockname()[1]
        self._stop_evt.clear()
        acceptor = threading.Thread(
            target=self._accept_loop, name="thapi-master-accept", daemon=True
        )
        acceptor.start()
        self._threads.append(acceptor)
        self._hub.start()
        if self.forward_to is not None:
            self._forwarder = SnapshotStreamer(
                self.forward_to,
                source=self.source,
                delta=self.forward_delta,
                resync_every=self.forward_resync_every,
                token=self.options.forward_token,
                ssl_context=self.options.build_forward_ssl(),
                connect_retries=self.options.connect_retries,
                connect_backoff_s=self.options.connect_backoff_s,
            )
            fwd = threading.Thread(
                target=self._forward_loop, name="thapi-master-forward", daemon=True
            )
            fwd.start()
            self._threads.append(fwd)
        return self

    def stop(self) -> None:
        """Flush upstream (local masters), close every connection, join threads."""
        self._stop_evt.set()
        if self._lsock is not None:
            try:
                # shutdown() wakes an acceptor blocked in accept(); close()
                # alone leaves it pinning the listening socket (and the
                # port) for the life of the process — a restarted master
                # could then never rebind the same port
                self._lsock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._lsock.close()
            except OSError:
                pass
            self._lsock = None
        if self._forwarder is not None:
            self.flush(force=True)  # last composite must reach the parent
            self._forwarder.close()
        self._hub.stop()
        with self._lock:
            conns, self._conns = self._conns, []
            threads, self._threads = list(self._threads), []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "MasterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def addr(self) -> str:
        """``host:port`` once started (``port=0`` is rebound at start)."""
        return f"{self.host}:{self.port}"

    @property
    def forwarder(self) -> Optional[SnapshotStreamer]:
        """The upstream push client (local masters only), for its counters."""
        return self._forwarder

    # -- state ---------------------------------------------------------------
    def submit(
        self,
        source: str,
        tally: Union[Tally, dict],
        seq: Optional[int] = None,
        gen: Optional[int] = None,
        tenant: str = DEFAULT_TENANT,
        telemetry: Optional[dict] = None,
        incarnation: int = 0,
    ) -> bool:
        """Ingest a full cumulative snapshot (socket handlers and the
        in-process tracer both land here). Out-of-order frames
        (seq < stored, same connection generation and incarnation) are stale
        duplicates of state we already supersede — dropped.  A frame from a
        *different* generation (reconnect, new session) always replaces: its
        snapshot is cumulative truth and its seq chain starts over.

        Incarnation fencing (elastic replacement): a frame whose
        ``incarnation`` is lower than the stored one comes from a superseded
        zombie — dropped and counted in ``fence_rejects``; a higher one
        atomically replaces the whole per-source state (seq chain, tally,
        telemetry), so the replacement's contribution can never be mixed
        with its predecessor's.

        Returns True when the state was stored.  False means the frame was
        dropped — a stale duplicate, a fenced incarnation, or a quota
        rejection for ``tenant`` (a *new* source past ``max_sources``, or a
        tally wider than ``max_tally_rows``; counted in the ``quota_*``
        stats).

        The master takes ownership of ``tally`` — callers must not mutate it
        afterwards (the incremental composite diffs stored states)."""
        if not isinstance(tally, Tally):
            tally = Tally.from_obj(tally)
        opts = self.options
        incarnation = int(incarnation)
        with self._lock:
            tn = self._tenant_locked(tenant)
            self._gc_sweep_locked()
            prev = tn.latest.get(source)
            if prev is not None and incarnation < prev.incarnation:
                self.fence_rejects += 1
                logger.warning(
                    "tenant %r: fenced snapshot from %r incarnation %d "
                    "(current %d)",
                    tenant,
                    source,
                    incarnation,
                    prev.incarnation,
                )
                return False
            if (
                prev is not None
                and incarnation == prev.incarnation
                and seq is not None
                and gen == prev.gen
                and seq < prev.seq
            ):
                return False
            if prev is None and opts.max_sources and len(tn.latest) >= opts.max_sources:
                self.quota_src_rejects += 1
                logger.warning(
                    "tenant %r: rejected new source %r (source quota %d reached)",
                    tenant,
                    source,
                    opts.max_sources,
                )
                return False
            if opts.max_tally_rows and (
                len(tally.apis) + len(tally.device_apis) > opts.max_tally_rows
            ):
                self.quota_row_rejects += 1
                logger.warning(
                    "tenant %r: rejected snapshot from %r (%d rows > quota %d)",
                    tenant,
                    source,
                    len(tally.apis) + len(tally.device_apis),
                    opts.max_tally_rows,
                )
                return False
            nseq = seq if seq is not None else (prev.seq + 1 if prev is not None else 0)
            old = prev.tally if prev is not None else None
            entry = tn.latest[source] = _SourceEntry(gen, nseq, tally, time.time())
            entry.incarnation = incarnation
            # a frame without telemetry keeps the last-known sample (leaf
            # pushes attach it every tick; forwarded chains may interleave)
            # — but never across an incarnation swap: the replacement's
            # telemetry starts clean, a zombie's vitals must not survive it
            same_inc = prev is not None and prev.incarnation == incarnation
            entry.telemetry = (
                dict(telemetry)
                if telemetry is not None
                else (prev.telemetry if same_inc else None)
            )
            # an admitted frame un-retires the row: the rank is live again
            entry.retired = prev.retired if same_inc else False
            self.snapshots += 1
            self.full_snapshots += 1
            self._dirty = True
            tn.dirty_srcs.add(source)
            tn.version += 1
            self._caches_note_update_locked(tn, source, old, tally, None)
        return True

    def submit_delta(
        self,
        source: str,
        delta: dict,
        seq: int,
        base_seq: int,
        gen: Optional[int] = None,
        tenant: str = DEFAULT_TENANT,
        telemetry: Optional[dict] = None,
        incarnation: int = 0,
    ) -> bool:
        """Ingest a delta frame; True if applied.

        Applies only when the stored state for ``source`` is exactly
        ``base_seq`` on the same connection generation *and incarnation* —
        anything else (unknown source after a master restart, a duplicate,
        an out-of-order frame, a reset seq, a different connection's chain)
        is rejected so the stored cumulative state is never corrupted; the
        socket handler then answers ``resync``.  A delta from a *lower*
        incarnation than stored is a zombie's late frame: counted in
        ``fence_rejects`` and dropped with **no** resync — a superseded
        sender must be cut off, not coached back into the fold.  A delta
        that would grow the stored tally past the tenant's
        ``max_tally_rows`` quota is rejected the same way as a chain
        mismatch (the follow-up full snapshot is then bounced by
        :meth:`submit`, so an over-quota source parks at its last admitted
        state).
        """
        opts = self.options
        incarnation = int(incarnation)
        with self._lock:
            tn = self._tenant_locked(tenant)
            self._gc_sweep_locked()
            prev = tn.latest.get(source)
            if prev is not None and incarnation < prev.incarnation:
                self.fence_rejects += 1
                logger.warning(
                    "tenant %r: fenced delta from %r incarnation %d (current %d)",
                    tenant,
                    source,
                    incarnation,
                    prev.incarnation,
                )
                return False
            if (
                prev is None
                or prev.gen != gen
                or prev.seq != base_seq
                or prev.incarnation != incarnation
            ):
                return False
            if opts.max_tally_rows:
                try:
                    grown = sum(
                        1
                        for prev_t, rows in (
                            (prev.tally.apis, delta["apis"]),
                            (prev.tally.device_apis, delta["device_apis"]),
                        )
                        for p, a, *_ in rows
                        if intern_key(p, a) not in prev_t
                    )
                except (KeyError, TypeError, ValueError):
                    return False  # malformed frame: ask for a resync
                rows = len(prev.tally.apis) + len(prev.tally.device_apis) + grown
                if rows > opts.max_tally_rows:
                    self.quota_row_rejects += 1
                    logger.warning(
                        "tenant %r: rejected delta from %r (%d rows > quota %d)",
                        tenant,
                        source,
                        rows,
                        opts.max_tally_rows,
                    )
                    return False
            # caches diff against the pre-apply state, so feed them first —
            # a delta names exactly the changed rows, the O(changed) path
            self._caches_note_update_locked(tn, source, prev.tally, None, delta)
            prev.tally.apply_delta(delta)
            prev.seq = seq
            prev.ts = time.time()
            prev.version += 1
            prev.snap = None  # stale frozen copy: re-snapped on next read
            if telemetry is not None:
                prev.telemetry = dict(telemetry)
            self.snapshots += 1
            self.deltas += 1
            self._dirty = True
            tn.dirty_srcs.add(source)
            tn.version += 1
        return True

    def _reset_seq(self, source: str, tenant: str = DEFAULT_TENANT) -> None:
        with self._lock:
            prev = self._tenant_locked(tenant).latest.get(source)
            if prev is not None:
                # keep the last tally but accept any future seq from it
                prev.seq = -1

    def incarnation_of(self, source: str, tenant: str = DEFAULT_TENANT) -> int:
        """Stored incarnation for ``source`` (-1 when the source is unknown).

        The socket handler uses this to tell a *fenced* rejection (frame
        incarnation < stored: answer ``error`` code ``"fence"`` and drop the
        connection) from an ordinary stale/mis-based drop (answer
        ``resync``)."""
        with self._lock:
            prev = self._tenant_locked(tenant).latest.get(source)
            return prev.incarnation if prev is not None else -1

    def retire_source(self, source: str, tenant: str = DEFAULT_TENANT) -> bool:
        """Tombstone ``source``: the rank was evicted from the mesh.

        Its cumulative contribution keeps counting toward the composite
        (the work it did is real), but per-rank readers see it flagged
        ``retired`` so UIs render the row as a tombstone instead of a live
        rank.  A frame from a *newer* incarnation un-retires the row (the
        replacement took over); same-incarnation frames — e.g. a drain's
        final flush racing the eviction — keep the flag.  Returns False for
        an unknown source."""
        with self._lock:
            tn = self._tenant_locked(tenant)
            prev = tn.latest.get(source)
            if prev is None:
                return False
            if not prev.retired:
                prev.retired = True
                tn.version += 1  # subscribers re-push with the tombstone
            return True

    def _gc_sweep_locked(self) -> None:
        """TTL sweep (``options.source_ttl_s``): drop sources whose last
        frame is older than the TTL — across every tenant.  Throttled to one
        sweep per TTL/4 so the ingest path never pays a per-frame scan;
        caller holds ``_lock``.  Collected sources leave the composite and
        rollup caches (dirty → rebuilt on next read) and bump
        ``source_gc``."""
        ttl = self.options.source_ttl_s
        if not ttl:
            return
        now = time.time()
        if now < self._gc_next:
            return
        self._gc_next = now + max(0.25, ttl / 4.0)
        for tn in self._tenants.values():
            dead = [src for src, e in tn.latest.items() if now - e.ts > ttl]
            for src in dead:
                del tn.latest[src]
                tn.dirty_srcs.discard(src)
                g = tn.src_group.pop(src, None)
                if g is not None:
                    members = tn.group_members.get(g)
                    if members is not None:
                        members.discard(src)
                    tn.group_dirty.add(g)
                self.source_gc += 1
                logger.info(
                    "tenant %r: collected dead source %r (no frames for > %.1fs)",
                    tn.name,
                    src,
                    ttl,
                )
            if dead:
                tn.comp_dirty = True
                tn.version += 1

    # -- cache maintenance (all called under self._lock) ---------------------
    def _caches_note_update_locked(
        self,
        tn: _Tenant,
        source: str,
        old: Optional[Tally],
        new: Optional[Tally],
        delta: Optional[dict],
    ) -> None:
        """Fold one source update into the tenant's composite/rollup caches.

        Exactly one of ``new`` (full snapshot replacing ``old``) or ``delta``
        (v2 delta about to be applied to ``old``) is set.  Monotone growth is
        applied incrementally — O(changed rows); anything else flips the
        affected cache to dirty and the next read rebuilds.
        """
        if self.composite_cache and not tn.comp_dirty and tn.comp is not None:
            ops = self._apply_to_acc(tn.comp, old, new, delta)
            if ops is None:
                tn.comp_dirty = True
            else:
                self.comp_row_ops += ops
                self.comp_incremental += 1
        else:
            tn.comp_dirty = True
        if self.rollup_groups is not None:
            g = self._group_of_locked(tn, source)
            tn.group_members.setdefault(g, set()).add(source)
            gt = tn.group_tallies.get(g)
            if g in tn.group_dirty:
                return
            if gt is None:
                # first update for this group: seed from the change itself
                # (old is None on a brand-new source; otherwise seed dirty)
                if old is None and new is not None:
                    seeded = Tally()
                    _tally_update_ops(seeded, None, new)
                    tn.group_tallies[g] = seeded
                else:
                    tn.group_dirty.add(g)
                return
            if self._apply_to_acc(gt, old, new, delta) is None:
                tn.group_dirty.add(g)

    @staticmethod
    def _apply_to_acc(
        acc: Tally, old: Optional[Tally], new: Optional[Tally], delta: Optional[dict]
    ) -> Optional[int]:
        if delta is not None:
            assert old is not None
            return _delta_update_ops(acc, old, delta)
        assert new is not None
        return _tally_update_ops(acc, old, new)

    def _comp_copies_locked(self, tn: _Tenant) -> Tuple[List[Tally], int]:
        """Rebuild input: per-source copies + the row-op count, one lock hold."""
        ops = sum(
            len(e.tally.apis) + len(e.tally.device_apis)
            for e in tn.latest.values()
        )
        return [Tally().merge(e.tally) for e in tn.latest.values()], ops

    def _finish_rebuild(
        self, tn: _Tenant, copies: List[Tally], ops: int, version: int
    ) -> Tally:
        """Merge a rebuild's source copies *outside* the lock (ingest never
        stalls behind an O(ranks × rows) merge), then store the result as the
        cache only if no ingest landed mid-rebuild (``version`` unchanged —
        a stale store would silently drop those updates).  Rebuilds go
        through the same ``fanout``-ary tree merge as the offline
        ``aggregate_tree`` (merge math is associative, so fanout shapes the
        work, never the result).  Returns a tally the caller owns."""
        if copies:
            comp, _ = merge_tallies(copies, fanout=self.fanout)
        else:
            comp = Tally()
        with self._lock:
            self.comp_rebuilds += 1
            self.comp_row_ops += ops
            if self.composite_cache and tn.version == version:
                tn.comp = comp
                tn.comp_dirty = False
                return Tally().merge(comp)
        # cache disabled, or state moved mid-rebuild (comp is still a
        # consistent read of the snapshot we copied): hand it out uncached
        return comp

    def _ranks_snapshot_locked(self, tn: _Tenant) -> Dict[str, Tally]:
        """Frozen per-source copies, refreshed only for sources whose state
        changed since the last read (version-stamped).  The returned tallies
        are shared snapshots: replaced wholesale on change, never mutated in
        place — safe to serialize or merge outside the lock, never to edit."""
        out = {}
        for src, e in tn.latest.items():
            if e.snap is None or e.snap_version != e.version:
                e.snap = Tally().merge(e.tally)
                e.snap_version = e.version
            out[src] = e.snap
        return out

    def _group_of_locked(self, tn: _Tenant, source: str) -> str:
        g = tn.src_group.get(source)
        if g is None:
            rg = self.rollup_groups
            if callable(rg):
                g = str(rg(source))
            elif isinstance(rg, int) and not isinstance(rg, bool):
                # host:pid:rankN → bucket rank indices rg-at-a-time
                tail = source.rpartition("rank")[2]
                if tail.isdigit():
                    g = f"group{int(tail) // max(1, rg)}"
                else:
                    g = source.partition(":")[0] or source
            else:  # "host" (the default string form)
                g = source.partition(":")[0] or source
            tn.src_group[source] = g
        return g

    def _rebuild_group_locked(self, tn: _Tenant, g: str) -> None:
        t = Tally()
        for src in tn.group_members.get(g, ()):
            e = tn.latest.get(src)
            if e is not None:
                t.merge(e.tally)
        tn.group_tallies[g] = t
        tn.group_dirty.discard(g)

    def _groups_locked(self, tn: _Tenant) -> Dict[str, Tally]:
        for g in list(tn.group_dirty):
            self._rebuild_group_locked(tn, g)
        return tn.group_tallies

    # -- reads ---------------------------------------------------------------
    def composite(self, tenant: str = DEFAULT_TENANT) -> Tally:
        """The merged cluster profile of one tenant, O(changed) in steady
        state.

        Maintained incrementally on ingest (full snapshots diff against the
        replaced state, deltas apply their changed rows directly), so a read
        copies the cached composite — O(distinct API rows) — instead of
        re-merging every source's whole table (O(ranks × rows), the
        pre-cache behavior, still reachable via ``composite_cache=False``).
        The returned tally is the caller's to mutate."""
        with self._lock:
            tn = self._tenant_locked(tenant)
            if self.composite_cache and tn.comp is not None and not tn.comp_dirty:
                return Tally().merge(tn.comp)
            version = tn.version
            copies, ops = self._comp_copies_locked(tn)
        return self._finish_rebuild(tn, copies, ops, version)

    def ranks(self, copy: bool = True, tenant: str = DEFAULT_TENANT) -> Dict[str, Tally]:
        """Per-source breakdown: source id → its latest cumulative tally.
        The data ``query_ranks`` serves and cluster-scope policies consume;
        merging all values reproduces :meth:`composite`.

        ``copy=True`` (default) returns defensive copies the caller owns.
        ``copy=False`` returns the version-stamped frozen snapshots — only
        sources that changed since the last read are re-copied (O(changed)),
        but callers must treat the tallies as read-only."""
        with self._lock:
            self._gc_sweep_locked()
            snap = self._ranks_snapshot_locked(self._tenant_locked(tenant))
            if copy:
                return {src: Tally().merge(t) for src, t in snap.items()}
            return dict(snap)

    def telemetry(self, tenant: str = DEFAULT_TENANT) -> Dict[str, dict]:
        """Per-source device telemetry: source id → its latest telemetry
        dict (host RSS, device memory pressure, transfer bandwidths — the
        fields in docs/streaming.md).  Sources whose frames never carried
        telemetry are absent.  Returns copies the caller owns — the same
        evidence ``query_ranks`` serves in its ``telemetry`` key and
        sick-host policies consume."""
        with self._lock:
            tn = self._tenant_locked(tenant)
            return {
                src: dict(e.telemetry)
                for src, e in tn.latest.items()
                if e.telemetry is not None
            }

    def groups(self, tenant: str = DEFAULT_TENANT) -> Dict[str, Tally]:
        """Rollup breakdown: group id → aggregated member tally (empty when
        ``rollup_groups`` is off).  Group tallies are maintained
        incrementally on ingest — the pre-aggregation layer that keeps
        >1k-rank trees readable: policies and upstream forwarding touch
        O(groups) tallies instead of O(ranks).  Returns defensive copies
        (group accumulators mutate in place on ingest, so — unlike the
        per-source snapshots — they can never be handed out uncopied)."""
        if self.rollup_groups is None:
            return {}
        with self._lock:
            tn = self._tenant_locked(tenant)
            return {g: Tally().merge(t) for g, t in self._groups_locked(tn).items()}

    def stats(self) -> dict:
        """Counters for monitoring: sources, frame/snapshot/delta/query
        totals, resyncs sent, composite-cache row-ops/rebuilds, rollup
        group count, last-update wall clock, forwarding role, plus the
        hardened-tier counters (auth/TLS failures, per-quota rejects,
        subscriber hub encode/fanout/eviction totals) and a ``per_tenant``
        source/subscriber breakdown.  Top-level ``sources``/``updated``/
        ``groups`` aggregate across tenants, so single-tenant callers see
        the historical shape unchanged."""
        with self._lock:
            self._gc_sweep_locked()
            per_tenant = {
                name: {
                    "sources": len(tn.latest),
                    "subscribers": tn.subscribers,
                    "updated": max((e.ts for e in tn.latest.values()), default=0.0),
                }
                for name, tn in self._tenants.items()
            }
        sources = sum(t["sources"] for t in per_tenant.values())
        subscribers = sum(t["subscribers"] for t in per_tenant.values())
        updated = max((t["updated"] for t in per_tenant.values()), default=0.0)
        with self._lock:
            groups = (
                sum(len(tn.group_members) for tn in self._tenants.values())
                if self.rollup_groups is not None
                else 0
            )
        return {
            "sources": sources,
            "frames": self.frames,
            "snapshots": self.snapshots,
            "full_snapshots": self.full_snapshots,
            "deltas": self.deltas,
            "resyncs": self.resyncs_sent,
            "queries": self.queries,
            "comp_row_ops": self.comp_row_ops,
            "comp_rebuilds": self.comp_rebuilds,
            "comp_incremental": self.comp_incremental,
            "groups": groups,
            "updated": updated,
            "forwarding": self.forward_to is not None,
            "tls": self._tls is not None,
            "auth": self.options.auth_required,
            "tenants": len(per_tenant),
            "per_tenant": per_tenant,
            "subscribers": subscribers,
            "auth_failures": self.auth_failures,
            "tls_failures": self.tls_failures,
            "quota_src_rejects": self.quota_src_rejects,
            "quota_row_rejects": self.quota_row_rejects,
            "quota_sub_rejects": self.quota_sub_rejects,
            "fence_rejects": self.fence_rejects,
            "source_gc": self.source_gc,
            "sub_encodes": self._hub.encodes,
            "sub_heartbeats": self._hub.heartbeats,
            "sub_frames": self._hub.frames_out,
            "sub_evictions": self._hub.evictions,
        }

    def flush(self, force: bool = False) -> bool:
        """Push state upstream now (local masters only): rollup-group
        tallies when ``rollup_groups`` is set (the pre-aggregated form —
        O(groups) upstream sources instead of O(ranks)), else the per-rank
        breakdown when ``forward_ranks``, else the merged composite.

        Forwarding is scoped to ``options.forward_tenant`` (the default
        tenant unless configured): interior hops of a master tree are
        single-tenant infrastructure, and tenant isolation at the serving
        edge must not leak other tenants' state upstream implicitly."""
        if self._forwarder is None:
            return False
        ftenant = self.options.forward_tenant
        with self._lock:
            tn = self._tenant_locked(ftenant)
            if not tn.latest or (not self._dirty and not force):
                return False
            self._dirty = False
        if self.rollup_groups is not None and self.forward_ranks:
            with self._lock:
                gro = self._groups_locked(tn)
                if force:
                    gs = list(gro)
                else:
                    gs = sorted(
                        {self._group_of_locked(tn, src) for src in tn.dirty_srcs}
                    )
                tn.dirty_srcs.clear()
                # group accumulators mutate in place on ingest: copy under
                # the lock, push outside it
                copies = {g: Tally().merge(gro[g]) for g in gs if g in gro}
            ok = True
            for g, tally in copies.items():
                ok = self._forwarder.push(
                    tally, source=g, skip_unchanged=not force
                ) and ok
            if not ok:
                with self._lock:
                    # parent unreachable: re-arm the failed groups' members
                    # so their state is re-forwarded when the parent returns
                    self._dirty = True
                    for g in copies:
                        tn.dirty_srcs.update(tn.group_members.get(g, ()))
        elif self.forward_ranks:
            with self._lock:
                # only updated sources are forwarded, via the version-stamped
                # frozen snapshots (no per-flush deep copies); a forced
                # (stop-path) flush re-sends every source in full
                snaps = self._ranks_snapshot_locked(tn)
                srcs = list(snaps) if force else list(tn.dirty_srcs)
                tn.dirty_srcs.clear()
                copies = {src: snaps[src] for src in srcs if src in snaps}
                telem = {
                    src: e.telemetry
                    for src, e in tn.latest.items()
                    if src in copies and e.telemetry is not None
                }
                # origin incarnations ride each forwarded chain, so the
                # fence holds at every level of the master tree
                incs = {
                    src: e.incarnation
                    for src, e in tn.latest.items()
                    if src in copies
                }
            ok = True
            for src, tally in copies.items():
                ok = self._forwarder.push(
                    tally,
                    source=src,
                    skip_unchanged=not force,
                    telemetry=telem.get(src),
                    incarnation=incs.get(src, 0),
                ) and ok
            if not ok:
                with self._lock:
                    # parent unreachable: re-arm the failed sources so their
                    # state is re-forwarded once the parent comes back
                    self._dirty = True
                    tn.dirty_srcs.update(copies)
        else:
            ok = self._forwarder.push(self.composite(tenant=ftenant))
            if not ok:
                with self._lock:
                    self._dirty = True
        return ok

    # -- threads -------------------------------------------------------------
    def _accept_loop(self) -> None:
        ls = self._lsock
        while not self._stop_evt.is_set():
            try:
                conn, _peer = ls.accept()
            except OSError:
                break
            t = threading.Thread(
                target=self._client_loop, args=(conn,), name="thapi-master-conn", daemon=True
            )
            with self._lock:
                self._threads.append(t)
            t.start()

    def _send_error(self, conn: socket.socket, code: str, detail: str) -> None:
        """Best-effort rejection frame; the connection closes right after."""
        try:
            conn.sendall(
                pack_frame(
                    {
                        "type": "error",
                        "v": PROTOCOL_VERSION,
                        "error": code,
                        "detail": detail,
                    }
                )
            )
        except OSError:
            pass

    def _client_loop(self, conn: socket.socket) -> None:
        peer = "?"
        try:
            peer = "%s:%d" % conn.getpeername()[:2]
        except OSError:
            pass
        if self._tls is not None:
            # handshake under a timeout so a plaintext/hostile client cannot
            # pin this thread; a plaintext client's first bytes fail to parse
            # as a TLS record and the handshake errors out cleanly
            try:
                conn.settimeout(5.0)
                conn = self._tls.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (OSError, ssl.SSLError):
                self.tls_failures += 1
                logger.warning("TLS handshake failed from %s", peer)
                try:
                    conn.close()
                except OSError:
                    pass
                with self._lock:
                    cur = threading.current_thread()
                    if cur in self._threads:
                        self._threads.remove(cur)
                return
        with self._lock:
            self._conns.append(conn)
            self._conn_gen += 1
            gen = self._conn_gen  # scopes this connection's seq chains
        # with auth on, no frame does anything until a hello carrying a
        # valid token binds the connection to a tenant
        tenant: Optional[str] = None if self.options.auth_required else DEFAULT_TENANT
        handed_off = False  # subscribe: the hub owns the socket from then on
        try:
            while not self._stop_evt.is_set():
                try:
                    msg = recv_frame(conn)
                except (ProtocolError, OSError):
                    break
                if msg is None:
                    break
                self.frames += 1
                kind = msg.get("type")
                if kind == "hello":
                    # a fresh connection restarts the peer's seq counter (e.g.
                    # a new Tracer session in the same process): forget the
                    # stored seq so its snapshots aren't dropped as stale.
                    # The ack tells v2 senders they may switch to deltas.
                    got = self.options.tenant_for(msg.get("token"))
                    if got is None:
                        self.auth_failures += 1
                        logger.warning(
                            "auth failure from %s (source %r): bad or missing token",
                            peer,
                            msg.get("source"),
                        )
                        self._send_error(conn, "auth", "invalid or missing token")
                        break
                    tenant = got
                    src = str(msg.get("source", "?"))
                    hello_inc = int(msg.get("incarnation", 0) or 0)
                    cur_inc = self.incarnation_of(src, tenant)
                    if hello_inc < cur_inc:
                        # a zombie incarnation reconnecting: fence it at the
                        # door — letting its hello through would reset the
                        # live incarnation's seq chain (_reset_seq below)
                        self.fence_rejects += 1
                        logger.warning(
                            "fenced hello from %s: %r incarnation %d "
                            "superseded by %d",
                            peer,
                            src,
                            hello_inc,
                            cur_inc,
                        )
                        self._send_error(
                            conn,
                            "fence",
                            f"incarnation {hello_inc} superseded by {cur_inc}",
                        )
                        break
                    self._reset_seq(src, tenant)
                    try:
                        conn.sendall(
                            pack_frame(
                                {
                                    "type": "hello_ack",
                                    "v": PROTOCOL_VERSION,
                                    "tenant": tenant,
                                }
                            )
                        )
                    except OSError:
                        break
                elif tenant is None:
                    self.auth_failures += 1
                    logger.warning(
                        "rejected %r frame from %s before authentication", kind, peer
                    )
                    self._send_error(
                        conn, "auth", "authenticate first: hello with token"
                    )
                    break
                elif kind == "snapshot":
                    source = str(msg.get("source", "?"))
                    inc = int(msg.get("incarnation", 0) or 0)
                    telem = msg.get("telemetry")
                    ok = self.submit(
                        source,
                        msg["tally"],
                        msg.get("seq"),
                        gen,
                        tenant=tenant,
                        telemetry=telem if isinstance(telem, dict) else None,
                        incarnation=inc,
                    )
                    if not ok and inc < self.incarnation_of(source, tenant):
                        # fenced zombie: tell it why and cut the connection
                        self._send_error(
                            conn, "fence", f"incarnation {inc} of {source} superseded"
                        )
                        break
                elif kind == "delta":
                    source = str(msg.get("source", "?"))
                    inc = int(msg.get("incarnation", 0) or 0)
                    telem = msg.get("telemetry")
                    ok = self.submit_delta(
                        source,
                        msg["delta"],
                        int(msg.get("seq", -1)),
                        int(msg.get("base_seq", -2)),
                        gen,
                        tenant=tenant,
                        telemetry=telem if isinstance(telem, dict) else None,
                        incarnation=inc,
                    )
                    if not ok:
                        if inc < self.incarnation_of(source, tenant):
                            # fenced zombie: no resync — coaching a superseded
                            # sender back to full snapshots would just feed
                            # more fenced frames; cut it off instead
                            self._send_error(
                                conn,
                                "fence",
                                f"incarnation {inc} of {source} superseded",
                            )
                            break
                        # mis-based delta: ask the sender for a full snapshot
                        # (scoped to the one source whose chain diverged)
                        self.resyncs_sent += 1
                        try:
                            conn.sendall(
                                pack_frame(
                                    {
                                        "type": "resync",
                                        "v": PROTOCOL_VERSION,
                                        "source": source,
                                    }
                                )
                            )
                        except OSError:
                            break
                elif kind == "query":
                    self.queries += 1
                    try:
                        conn.sendall(pack_frame(self._composite_msg(tenant=tenant)))
                    except OSError:
                        break
                elif kind == "query_ranks":
                    self.queries += 1
                    try:
                        conn.sendall(pack_frame(self._ranks_msg(tenant=tenant)))
                    except OSError:
                        break
                elif kind == "query_groups":
                    self.queries += 1
                    try:
                        conn.sendall(pack_frame(self._groups_msg(tenant=tenant)))
                    except OSError:
                        break
                elif kind == "subscribe":
                    # hand the connection to the broadcast hub: frames are
                    # encoded once per tenant per update and fanned out to
                    # every subscriber from shared buffers
                    period = float(msg.get("period_s", 1.0))
                    by_rank = bool(msg.get("by_rank", False))
                    with self._lock:
                        tn = self._tenant_locked(tenant)
                        if (
                            self.options.max_subscribers
                            and tn.subscribers >= self.options.max_subscribers
                        ):
                            self.quota_sub_rejects += 1
                            admitted = False
                        else:
                            tn.subscribers += 1
                            admitted = True
                    if not admitted:
                        logger.warning(
                            "tenant %r: rejected subscribe from %s (quota %d)",
                            tenant,
                            peer,
                            self.options.max_subscribers,
                        )
                        self._send_error(conn, "quota", "subscriber quota reached")
                        break
                    self._hub.add(conn, tenant, period, by_rank)
                    handed_off = True
                    break
                elif kind == "ping":
                    try:
                        conn.sendall(pack_frame({"type": "pong", "v": PROTOCOL_VERSION}))
                    except OSError:
                        break
                elif kind == "bye":
                    break
                # unknown types: ignored, no reply needed
        finally:
            if not handed_off:
                try:
                    conn.close()
                except OSError:
                    pass
            # long-lived masters see many short query connections: prune, or
            # _conns/_threads grow without bound
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                cur = threading.current_thread()
                if cur in self._threads:
                    self._threads.remove(cur)

    def _forward_loop(self) -> None:
        while not self._stop_evt.wait(self.forward_period_s):
            self.flush()

    def _tenant_meta_locked(self, tn: _Tenant) -> dict:
        """Reply meta, scoped to one tenant's sources (frame/delta counters
        stay master-global: they are load telemetry, not state)."""
        return {
            "sources": len(tn.latest),
            "snapshots": self.snapshots,
            "deltas": self.deltas,
            "updated": max((e.ts for e in tn.latest.values()), default=0.0),
        }

    def _composite_msg(
        self, by_rank: bool = False, tenant: str = DEFAULT_TENANT
    ) -> dict:
        # one snapshot under one lock: a frame's composite and per-rank map
        # must describe the same instant, or a subscriber cross-checking
        # invariant 7 (per-rank sums == composite) sees spurious mismatches
        # whenever a submit races the push.  Both sides come from the
        # incremental caches — no per-query re-merge of every source — and
        # the frozen snapshots are safe to serialize outside the lock.  On
        # the rare rebuild, the source copies and the per-rank snapshot are
        # taken under the same hold (same instant) and the merge runs
        # outside the lock so ingest never stalls behind it.
        comp = None
        with self._lock:
            tn = self._tenant_locked(tenant)
            if self.composite_cache and tn.comp is not None and not tn.comp_dirty:
                comp = Tally().merge(tn.comp)
            else:
                version = tn.version
                copies, ops = self._comp_copies_locked(tn)
            snap = self._ranks_snapshot_locked(tn) if by_rank else None
            incs = (
                {src: e.incarnation for src, e in tn.latest.items()}
                if by_rank
                else None
            )
            retired = (
                [src for src, e in tn.latest.items() if e.retired]
                if by_rank
                else None
            )
            meta = self._tenant_meta_locked(tn)
        if comp is None:
            comp = self._finish_rebuild(tn, copies, ops, version)
        msg = {"type": "composite", "v": PROTOCOL_VERSION, "tally": comp.to_obj()}
        msg.update(meta)
        if by_rank:
            msg["ranks"] = {src: t.to_obj() for src, t in snap.items()}
            msg["incarnations"] = incs
            if retired:
                msg["retired"] = retired
        return msg

    def _heartbeat_msg(self, tenant: str = DEFAULT_TENANT) -> dict:
        """Tally-less ``unchanged`` frame for idle subscription periods."""
        with self._lock:
            meta = self._tenant_meta_locked(self._tenant_locked(tenant))
        msg = {"type": "composite", "v": PROTOCOL_VERSION, "unchanged": True}
        msg.update(meta)
        return msg

    def _ranks_msg(self, tenant: str = DEFAULT_TENANT) -> dict:
        """``query_ranks`` reply: the per-source tally map + receipt times."""
        with self._lock:
            tn = self._tenant_locked(tenant)
            self._gc_sweep_locked()
            snap = self._ranks_snapshot_locked(tn)
            stamps = {src: e.ts for src, e in tn.latest.items()}
            telem = {
                src: dict(e.telemetry)
                for src, e in tn.latest.items()
                if e.telemetry is not None
            }
            incs = {src: e.incarnation for src, e in tn.latest.items()}
            retired = [src for src, e in tn.latest.items() if e.retired]
            meta = self._tenant_meta_locked(tn)
        # frozen snapshots: replaced wholesale on change, safe to serialize
        # after the lock is released
        msg = {
            "type": "ranks",
            "v": PROTOCOL_VERSION,
            "ranks": {src: t.to_obj() for src, t in snap.items()},
            "ts": stamps,
            "incarnations": incs,
        }
        if telem:
            msg["telemetry"] = telem
        if retired:
            msg["retired"] = retired
        msg.update(meta)
        return msg

    def _groups_msg(self, tenant: str = DEFAULT_TENANT) -> dict:
        """``query_groups`` reply: the rollup breakdown (empty when off)."""
        gro = self.groups(tenant=tenant)
        with self._lock:
            meta = self._tenant_meta_locked(self._tenant_locked(tenant))
        msg = {
            "type": "groups",
            "v": PROTOCOL_VERSION,
            "rollup": self.rollup_groups is not None,
            "groups": {g: t.to_obj() for g, t in gro.items()},
        }
        msg.update(meta)
        return msg


# ---------------------------------------------------------------------------
# Broadcast hub: encode-once subscription fanout
# ---------------------------------------------------------------------------


class _Subscriber:
    """One subscribed connection: a bounded frame queue drained by a
    dedicated sender thread.  The hub *offers* encoded frames; the sender
    pushes them down the socket at whatever pace the client sustains.  A
    full queue means the client is not keeping up — the subscriber is
    evicted rather than allowed to stall the hub or balloon memory."""

    __slots__ = (
        "conn",
        "tenant",
        "period_s",
        "by_rank",
        "maxq",
        "queue",
        "cv",
        "closed",
        "next_due",
        "last_version",
        "thread",
    )

    def __init__(
        self,
        conn: socket.socket,
        tenant: str,
        period_s: float,
        by_rank: bool,
        maxq: int,
    ):
        self.conn = conn
        self.tenant = tenant
        self.period_s = max(0.01, float(period_s))
        self.by_rank = bool(by_rank)
        self.maxq = maxq
        self.queue: collections.deque = collections.deque()
        self.cv = threading.Condition()
        self.closed = False
        self.next_due = 0.0  # due immediately: snapshot-on-join
        self.last_version: Optional[int] = None
        self.thread: Optional[threading.Thread] = None


class _BroadcastHub:
    """Shared subscription fanout for a :class:`MasterServer`.

    Replaces the per-client ``_subscription_loop`` (one render + serialize
    per subscriber per period) with a single hub thread: each composite
    update is encoded **once per (tenant, by_rank) variant** — the encoded
    bytes are shared by every subscriber's queue, so 1 and 512 subscribers
    cost the same serialization work (``encodes`` stays flat; the stream_bw
    fanout sweep measures exactly this).  Encoded frames are version-stamped
    and cached, so a late joiner of an idle tenant reuses the last encode
    (snapshot-on-join without a re-render).

    Per-subscriber pacing (``period_s``) and change-gating are preserved
    from the old loop: an idle period ships a tiny tally-less heartbeat.
    Slow consumers are evicted on queue overflow (``evictions``) — their
    socket is shut down, which also unblocks a sender mid-``sendall``."""

    def __init__(self, master: "MasterServer"):
        self.m = master
        self._subs: List[_Subscriber] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: (tenant, by_rank) → (tenant version, encoded composite frame)
        self._cache: Dict[Tuple[str, bool], Tuple[int, bytes]] = {}
        self.encodes = 0  # composite serializations (once per tenant/update)
        self.heartbeats = 0  # idle-period heartbeat frames built
        self.frames_out = 0  # frames enqueued across all subscribers
        self.evictions = 0  # slow subscribers dropped on queue overflow

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="thapi-hub", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Retire every subscriber and join the hub + sender threads.
        Relies on the master's ``_stop_evt`` being set already."""
        with self._lock:
            subs, self._subs = list(self._subs), []
        for sub in subs:
            self._retire(sub)
            try:
                sub.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        for sub in subs:
            if sub.thread is not None:
                sub.thread.join(timeout=2.0)
        self._cache.clear()

    def add(
        self, conn: socket.socket, tenant: str, period_s: float, by_rank: bool
    ) -> None:
        """Adopt a connection whose client sent ``subscribe`` (the caller
        already charged the tenant's subscriber quota)."""
        sub = _Subscriber(
            conn, tenant, period_s, by_rank, self.m.options.hub_queue_frames
        )
        sub.thread = threading.Thread(
            target=self._sender, args=(sub,), name="thapi-hub-send", daemon=True
        )
        with self._lock:
            self._subs.append(sub)
        sub.thread.start()
        self._wake.set()  # first frame (snapshot-on-join) goes out now

    # -- internals ----------------------------------------------------------
    def _retire(self, sub: _Subscriber, evicted: bool = False) -> bool:
        """Close out a subscriber exactly once (uncharge quota, optionally
        count the eviction and shut the socket down to unblock its sender)."""
        with sub.cv:
            if sub.closed:
                return False
            sub.closed = True
            sub.cv.notify_all()
        with self.m._lock:
            self.m._tenant_locked(sub.tenant).subscribers -= 1
        if evicted:
            self.evictions += 1
            logger.warning(
                "evicted slow subscriber (tenant %r): %d-frame queue full",
                sub.tenant,
                sub.maxq,
            )
            try:
                sub.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        return True

    def _offer(self, sub: _Subscriber, frame: bytes) -> None:
        with sub.cv:
            if sub.closed:
                return
            if len(sub.queue) < sub.maxq:
                sub.queue.append(frame)
                self.frames_out += 1
                sub.cv.notify_all()
                return
        # queue full: the client is slower than its own requested period —
        # evict instead of stalling the hub behind one bad consumer
        self._retire(sub, evicted=True)

    def _sender(self, sub: _Subscriber) -> None:
        """Drain one subscriber's queue onto its socket (the only thread
        that writes to it after handoff)."""
        stop = self.m._stop_evt
        try:
            while True:
                with sub.cv:
                    while not sub.queue and not sub.closed and not stop.is_set():
                        sub.cv.wait(0.5)
                    if not sub.queue:
                        break  # closed or stopping, nothing left to drain
                    frame = sub.queue.popleft()
                try:
                    sub.conn.sendall(frame)
                except OSError:
                    break  # client went away (or eviction shut us down)
        finally:
            self._retire(sub)
            try:
                sub.conn.close()
            except OSError:
                pass

    def _loop(self) -> None:
        m = self.m
        stop = m._stop_evt
        while not stop.is_set():
            with self._lock:
                subs = [s for s in self._subs if not s.closed]
                self._subs = subs  # prune retired subscribers
            if not subs:
                self._wake.wait(0.2)
                self._wake.clear()
                continue
            now = time.monotonic()
            hb_cache: Dict[str, bytes] = {}  # tenant → heartbeat, this tick
            next_due = now + 1.0
            for sub in subs:
                if now + 1e-9 < sub.next_due:
                    next_due = min(next_due, sub.next_due)
                    continue
                sub.next_due = now + sub.period_s
                next_due = min(next_due, sub.next_due)
                with m._lock:
                    version = m._tenant_locked(sub.tenant).version
                if sub.last_version == version:
                    # no state change since this subscriber's last full
                    # frame: tiny heartbeat, shared across the tick
                    frame = hb_cache.get(sub.tenant)
                    if frame is None:
                        frame = pack_frame(m._heartbeat_msg(sub.tenant))
                        hb_cache[sub.tenant] = frame
                    self.heartbeats += 1
                else:
                    key = (sub.tenant, sub.by_rank)
                    ent = self._cache.get(key)
                    if ent is None or ent[0] != version:
                        # THE fanout invariant: this encode happens once per
                        # tenant/variant per update, not once per subscriber
                        ent = (
                            version,
                            pack_frame(
                                m._composite_msg(
                                    by_rank=sub.by_rank, tenant=sub.tenant
                                )
                            ),
                        )
                        self._cache[key] = ent
                        self.encodes += 1
                    sub.last_version = ent[0]
                    frame = ent[1]
                self._offer(sub, frame)
            delay = max(0.0, min(next_due - time.monotonic(), 1.0))
            if delay:
                self._wake.wait(delay)
                self._wake.clear()


# ---------------------------------------------------------------------------
# Query clients (iprof top, serve layer, tests)
# ---------------------------------------------------------------------------

_COMPOSITE_META_KEYS = ("sources", "snapshots", "deltas", "updated")


def _check_rejection(msg: Optional[dict]) -> None:
    """Raise :class:`ServerRejected` if the server answered an error frame."""
    if isinstance(msg, dict) and msg.get("type") == "error":
        raise ServerRejected(
            str(msg.get("error", "?")), str(msg.get("detail", ""))
        )


class StreamClient:
    """The one authenticated client for every master read path.

    One reusable connection, one place for TLS + token credentials, every
    query the protocol offers::

        with StreamClient("127.0.0.1:9000", token="s3cret", tls_ca="ca.pem") as c:
            tally, meta = c.composite()
            ranks, meta = c.ranks()
            for tally, meta in c.subscribe(period_s=1.0):
                ...

    ``connect()`` is lazy (first request connects) and performs the
    ``hello`` handshake: credentials are presented once per connection, and
    the master's ``hello_ack`` reveals the bound ``tenant`` and
    ``server_version``.  Requests transparently reconnect **once** when a
    pooled connection turns out dead (master restarted between polls) —
    fresh failures still raise, so an unreachable master is reported, not
    retried forever.  Auth/quota rejections raise :class:`ServerRejected`
    (a ``ProtocolError``), transport trouble raises ``OSError`` /
    ``ProtocolError`` exactly like the old one-shot helpers.

    Thread-safe for requests (one in flight at a time, guarded by a lock);
    ``subscribe`` detaches its connection from the pool, so a subscription
    and further queries can share one client.
    """

    def __init__(
        self,
        addr: Union[str, Tuple[str, int]],
        timeout_s: float = 3.0,
        token: Optional[str] = None,
        tls_ca: Optional[str] = None,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        server_hostname: Optional[str] = None,
        source: Optional[str] = None,
    ):
        self.addr = parse_addr(addr)
        self.timeout_s = timeout_s
        self.token = token
        if ssl_context is None and (tls_ca or tls_cert):
            ssl_context = client_ssl_context(
                cafile=tls_ca, certfile=tls_cert, keyfile=tls_key
            )
        self.ssl_context = ssl_context
        self.server_hostname = server_hostname or self.addr[0]
        self.source = source or f"client:{socket.gethostname()}:{os.getpid()}"
        #: tenant the master bound this client to (after the first connect)
        self.tenant: Optional[str] = None
        #: master's protocol version from ``hello_ack``
        self.server_version: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    def connect(self) -> "StreamClient":
        """Connect + authenticate now (requests do this lazily)."""
        with self._lock:
            self._connect_locked()
        return self

    def close(self) -> None:
        with self._lock:
            self._close_locked(say_bye=True)

    def __enter__(self) -> "StreamClient":
        return self.connect()  # surface auth/TLS errors at the `with`, not mid-loop

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect_locked(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        s = socket.create_connection(self.addr, timeout=self.timeout_s)
        try:
            s.settimeout(self.timeout_s)
            if self.ssl_context is not None:
                s = self.ssl_context.wrap_socket(
                    s, server_hostname=self.server_hostname
                )
            hello = {"type": "hello", "v": PROTOCOL_VERSION, "source": self.source}
            if self.token is not None:
                hello["token"] = self.token
            s.sendall(pack_frame(hello))
            ack = recv_frame(s)
            _check_rejection(ack)
            if ack is None:
                raise ProtocolError("connection closed during handshake")
            if ack.get("type") != "hello_ack":
                raise ProtocolError(f"expected hello_ack, got {ack!r}")
            self.server_version = int(ack.get("v", 1))
            self.tenant = ack.get("tenant")
        except BaseException:
            try:
                s.close()
            except OSError:
                pass
            raise
        self._sock = s
        return s

    def _close_locked(self, say_bye: bool = False) -> None:
        s, self._sock = self._sock, None
        if s is None:
            return
        if say_bye:
            try:
                s.sendall(pack_frame({"type": "bye", "source": self.source}))
            except OSError:
                pass
        try:
            s.close()
        except OSError:
            pass

    # -- request/response ---------------------------------------------------
    def _request(self, msg: dict, expect: str) -> dict:
        with self._lock:
            for attempt in (0, 1):
                pooled = self._sock is not None
                s = self._connect_locked()
                try:
                    s.sendall(pack_frame(msg))
                    reply = recv_frame(s)
                except (ProtocolError, OSError):
                    self._close_locked()
                    if not pooled or attempt:
                        raise
                    continue  # stale pooled conn: one transparent reconnect
                if reply is None:
                    self._close_locked()
                    if not pooled or attempt:
                        raise ProtocolError("connection closed by server")
                    continue
                _check_rejection(reply)
                if reply.get("type") != expect:
                    raise ProtocolError(f"expected {expect} reply, got {reply!r}")
                return reply
        raise AssertionError("unreachable")  # pragma: no cover

    def ping(self) -> bool:
        """Round-trip liveness check."""
        self._request({"type": "ping", "v": PROTOCOL_VERSION}, "pong")
        return True

    def composite(self) -> Tuple[Tally, dict]:
        """Fetch (composite tally, meta) for this client's tenant."""
        msg = self._request({"type": "query", "v": PROTOCOL_VERSION}, "composite")
        meta = {k: msg[k] for k in _COMPOSITE_META_KEYS if k in msg}
        return Tally.from_obj(msg["tally"]), meta

    def ranks(self) -> Tuple[Dict[str, Tally], dict]:
        """Fetch the per-rank breakdown.

        Returns ``(ranks, meta)`` where ``ranks`` maps source id (the rank
        identity, ``host:pid:rankN``) → its latest cumulative tally, and
        ``meta`` carries the composite meta keys plus ``ts`` (source →
        receipt wall clock), ``telemetry`` (source → its latest
        device-telemetry dict, empty when no source shipped any),
        ``incarnations`` (source → incarnation number; 0 for sources that
        were never replaced) and ``retired`` (sources tombstoned by an
        eviction — render distinctly, their contribution still counts).
        Merging every value of ``ranks`` reproduces the :meth:`composite`
        tally exactly — per-rank sums equal the composite, API for API."""
        msg = self._request({"type": "query_ranks", "v": PROTOCOL_VERSION}, "ranks")
        meta = {k: msg[k] for k in _COMPOSITE_META_KEYS if k in msg}
        meta["ts"] = msg.get("ts", {})
        telem = msg.get("telemetry")
        meta["telemetry"] = telem if isinstance(telem, dict) else {}
        incs = msg.get("incarnations")
        meta["incarnations"] = incs if isinstance(incs, dict) else {}
        retired = msg.get("retired")
        meta["retired"] = list(retired) if isinstance(retired, (list, tuple)) else []
        return {src: Tally.from_obj(o) for src, o in msg["ranks"].items()}, meta

    def groups(self) -> Tuple[Dict[str, Tally], dict]:
        """Fetch the rollup-group breakdown.

        Returns ``(groups, meta)`` where ``groups`` maps group id (e.g. a
        hostname, or ``groupK`` rank buckets) → the aggregated tally of its
        member sources, and ``meta`` carries the composite meta keys plus
        ``rollup`` (False when the master runs without ``rollup_groups`` —
        the map is then empty).  Merging every group reproduces the
        composite, so >1k-rank trees can be read at node granularity
        without shipping or merging per-rank tables."""
        msg = self._request(
            {"type": "query_groups", "v": PROTOCOL_VERSION}, "groups"
        )
        meta = {k: msg[k] for k in _COMPOSITE_META_KEYS if k in msg}
        meta["rollup"] = bool(msg.get("rollup", False))
        return {g: Tally.from_obj(o) for g, o in msg["groups"].items()}, meta

    def subscribe(
        self, period_s: float = 1.0, by_rank: bool = False
    ) -> Iterator[Tuple[Tally, dict]]:
        """Subscribe: yields (composite, meta) as the master pushes.

        The generator *detaches* the client's pooled connection and owns it
        (the master's hub writes to it from then on); the client's next
        request opens a fresh connection, so one ``StreamClient`` can serve
        a subscription and queries side by side.  The generator ends on
        master shutdown (clean EOF) and raises ``OSError`` /
        ``ProtocolError`` on transport trouble.  Close the generator to
        disconnect.

        Idle periods arrive as tally-less heartbeats (the master only
        re-serializes the composite when state changed); the generator then
        re-yields the previous tally with ``meta["unchanged"] = True``, so
        consumers always see a renderable composite per period.

        With ``by_rank`` every full push also carries the per-source
        breakdown, surfaced as ``meta["ranks"]`` (source → Tally);
        heartbeats re-yield the cached breakdown like the cached composite.
        """
        with self._lock:
            s = self._connect_locked()
            self._sock = None  # detach: the subscription owns this socket
        try:
            s.settimeout(max(self.timeout_s, 2 * period_s))
            s.sendall(
                pack_frame(
                    {
                        "type": "subscribe",
                        "v": PROTOCOL_VERSION,
                        "period_s": period_s,
                        "by_rank": by_rank,
                    }
                )
            )
            last_tally: Optional[Tally] = None
            last_ranks: Optional[Dict[str, Tally]] = None
            last_incs: Dict[str, int] = {}
            last_retired: List[str] = []
            while True:
                msg = recv_frame(s)
                if msg is None:  # master stopped: end of stream
                    return
                _check_rejection(msg)  # e.g. subscriber quota reached
                if msg.get("type") != "composite":
                    raise ProtocolError(f"expected composite frame, got {msg!r}")
                meta = {k: msg[k] for k in _COMPOSITE_META_KEYS if k in msg}
                if "tally" in msg:
                    last_tally = Tally.from_obj(msg["tally"])
                    if "ranks" in msg:
                        last_ranks = {
                            src: Tally.from_obj(o) for src, o in msg["ranks"].items()
                        }
                        incs = msg.get("incarnations")
                        last_incs = incs if isinstance(incs, dict) else {}
                        ret = msg.get("retired")
                        last_retired = (
                            list(ret) if isinstance(ret, (list, tuple)) else []
                        )
                elif last_tally is None:
                    raise ProtocolError("unchanged heartbeat before any composite")
                else:
                    meta["unchanged"] = True
                if by_rank and last_ranks is not None:
                    meta["ranks"] = last_ranks
                    meta["incarnations"] = last_incs
                    meta["retired"] = last_retired
                yield last_tally, meta
        finally:
            try:
                s.close()
            except OSError:
                pass


# -- deprecated one-shot shims (the pre-StreamClient module-level API) ------


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old}() is deprecated; use {new}",
        DeprecationWarning,
        stacklevel=3,
    )


def query_composite(
    addr: Union[str, Tuple[str, int]], timeout_s: float = 3.0, **client_kw
) -> Tuple[Tally, dict]:
    """Deprecated shim: use :meth:`StreamClient.composite`."""
    _warn_deprecated("query_composite", "StreamClient(addr).composite()")
    with StreamClient(addr, timeout_s=timeout_s, **client_kw) as c:
        return c.composite()


def query_ranks(
    addr: Union[str, Tuple[str, int]], timeout_s: float = 3.0, **client_kw
) -> Tuple[Dict[str, Tally], dict]:
    """Deprecated shim: use :meth:`StreamClient.ranks`."""
    _warn_deprecated("query_ranks", "StreamClient(addr).ranks()")
    with StreamClient(addr, timeout_s=timeout_s, **client_kw) as c:
        return c.ranks()


def query_groups(
    addr: Union[str, Tuple[str, int]], timeout_s: float = 3.0, **client_kw
) -> Tuple[Dict[str, Tally], dict]:
    """Deprecated shim: use :meth:`StreamClient.groups`."""
    _warn_deprecated("query_groups", "StreamClient(addr).groups()")
    with StreamClient(addr, timeout_s=timeout_s, **client_kw) as c:
        return c.groups()


def subscribe_composites(
    addr: Union[str, Tuple[str, int]],
    period_s: float = 1.0,
    timeout_s: float = 10.0,
    by_rank: bool = False,
    **client_kw,
) -> Iterator[Tuple[Tally, dict]]:
    """Deprecated shim: use :meth:`StreamClient.subscribe`."""
    _warn_deprecated("subscribe_composites", "StreamClient(addr).subscribe()")
    c = StreamClient(addr, timeout_s=timeout_s, **client_kw)
    try:
        yield from c.subscribe(period_s=period_s, by_rank=by_rank)
    finally:
        c.close()


def live_snapshot() -> Optional[Tally]:
    """Global live profile of the *current process*, if a session is tracing.

    With ``serve_port`` set the tracer runs an in-process master, so the
    snapshot covers every source streaming to it (the global view); plain
    ``online=True`` yields this rank's own live tally; otherwise None.
    """
    from .tracer import active_tracer

    tr = active_tracer()
    if tr is None:
        return None
    server = getattr(tr, "server", None)
    if server is not None:
        return server.composite()
    if tr.online is not None:
        return tr.online.snapshot()
    return None
