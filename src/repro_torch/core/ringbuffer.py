"""Per-thread ring buffers with discard mode (THAPI §3.1 / LTTng).

LTTng's key collection property: *lockless per-CPU ring buffers* — no
inter-core communication on the producer hot path — and *discard mode*: if
the consumer cannot keep up, new events are dropped (counted) rather than
blocking the traced application.

We reproduce the architecture with per-*thread* byte rings (the Python
analogue of per-CPU: under the GIL a thread owns its ring's write end).  The
design is single-producer/single-consumer:

  producer (traced thread)  — writes framed records at ``head``; only ever
                              advances ``head``; never blocks; drops when full.
  consumer (flusher daemon) — reads the committed region and advances
                              ``tail``; never touches ``head``.

``head``/``tail`` are monotonically increasing Python ints; a reader sees
either the old or the new binding (GIL-atomic), so the committed prefix is
always consistent.  Data is written *before* ``head`` is published, which is
the same publish protocol as LTTng's sub-buffer commit counters.

Two producer protocols share that publish ordering:

  ``write(record)``        — legacy: the caller builds the framed record as
                             one ``bytes`` object and the ring copies it in.
  ``reserve(n)/commit(n)`` — zero-allocation: the producer asks for ``n``
                             contiguous bytes, packs fields *directly into
                             ring storage* (``wbuf`` at the returned offset)
                             and then publishes.  On the common non-wrap path
                             no intermediate object is allocated; when the
                             record would straddle the physical end of the
                             ring, ``reserve`` stages the write through one
                             reusable per-ring scratch ``bytearray`` and
                             ``commit`` copies the two halves into place —
                             the ring *content* is identical either way.

Producers on the reserve path may additionally bound-check against ``_lim``
(`head`-space address below which a record is guaranteed to fit without
wrapping or overwriting unconsumed data) to skip ``reserve`` entirely:
``_lim`` is only ever advanced by ``reserve`` from a fresh ``tail`` read, so
a stale value is conservative — the generated tracepoints lean on this for
their single-compare fast path.

Record framing (little-endian):
    u32  total record length (including this header)
    u16  event id
    u64  timestamp (monotonic ns)
    ...  payload (per-event schema, packed by the generated tracepoints)
"""

from __future__ import annotations

import struct
import threading
from typing import List, Optional, Tuple

RECORD_HEADER = struct.Struct("<IHQ")
RECORD_HEADER_SIZE = RECORD_HEADER.size  # 14 bytes


class RingBuffer:
    """One SPSC byte ring. Capacity must be a power of two."""

    __slots__ = (
        "capacity",
        "_mask",
        "_buf",
        "_mv",
        "head",
        "tail",
        "dropped",
        "events",
        "wbuf",
        "_scratch",
        "_lim",
        "_pending",
        "pid",
        "tid",
        "tname",
    )

    def __init__(self, capacity: int, pid: int = 0, tid: int = 0, tname: str = ""):
        if capacity & (capacity - 1) or capacity <= 0:
            raise ValueError("ring capacity must be a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self._buf = bytearray(capacity)
        self._mv = memoryview(self._buf)  # zero-copy drain slices come from here
        self.head = 0  # producer-owned
        self.tail = 0  # consumer-owned
        self.dropped = 0  # producer-owned (discard-mode counter)
        self.events = 0  # records written (write()/recorders; commit() is agnostic)
        #: buffer the producer packs into after ``reserve``: the ring storage
        #: itself on the non-wrap path, the scratch staging area otherwise
        self.wbuf = self._buf
        self._scratch = bytearray(0)
        #: producer-cached fast-path bound: head-space address up to which a
        #: record fits without wrap/overwrite. Stale values are conservative.
        self._lim = capacity
        self._pending = 0  # head snapshot of the outstanding drain_view
        self.pid = pid
        self.tid = tid
        self.tname = tname

    # -- producer hot path ---------------------------------------------------

    def write(self, record: bytes) -> bool:
        """Append one framed record; drop (never block) when full."""
        n = len(record)
        if n > self.capacity - (self.head - self.tail):
            self.dropped += 1
            return False
        h = self.head & self._mask
        end = h + n
        if end <= self.capacity:
            self._buf[h:end] = record
        else:  # wrap: zero-copy halves via memoryview (record[:k] would copy)
            k = self.capacity - h
            mv = memoryview(record)
            self._buf[h:] = mv[:k]
            self._buf[: n - k] = mv[k:]
        self.head += n  # publish (single int store under the GIL)
        self.events += 1
        return True

    def reserve(self, n: int) -> int:
        """Claim ``n`` bytes; return the ``wbuf`` offset to pack into, -1 = drop.

        Does not publish: the producer packs the record into ``self.wbuf`` at
        the returned offset, then calls :meth:`commit`.  ``head`` is untouched
        until then, so an exception between reserve and commit leaves the ring
        consistent (the reservation is simply forgotten).  Also refreshes
        ``_lim`` from a fresh ``tail`` read so subsequent records can skip
        straight to packing while ``head + n <= _lim`` holds.
        """
        h = self.head
        if n > self.capacity - (h - self.tail):
            self.dropped += 1
            return -1
        o = h & self._mask
        # fast-path bound for the generated recorders: stop at whichever comes
        # first, the consumer's tail + one capacity or the physical wrap point
        self._lim = min(self.tail + self.capacity, h - o + self.capacity)
        if o + n <= self.capacity:
            self.wbuf = self._buf
            return o
        # wrap: stage through the reusable scratch buffer (rare; one
        # allocation the first time it grows, then reused)
        if len(self._scratch) < n:
            self._scratch = bytearray(n)
        self.wbuf = self._scratch
        return 0

    def commit(self, n: int) -> None:
        """Publish the ``n`` bytes packed after :meth:`reserve`.

        Non-wrap: the record is already in ring storage; publishing is one
        ``head`` store.  Wrap: copy the scratch halves into place first (data
        lands before ``head`` moves — same ordering as :meth:`write`).
        ``events`` is *not* incremented here: reserve/commit callers account
        records themselves (a fused pair recorder commits two at once).
        """
        wb = self.wbuf
        if wb is not self._buf:
            h = self.head & self._mask
            k = self.capacity - h
            mv = memoryview(wb)
            self._buf[h:] = mv[:k]
            self._buf[: n - k] = mv[k:n]
            self.wbuf = self._buf
        self.head += n  # publish (single int store under the GIL)

    # -- consumer side ---------------------------------------------------------

    def drain(self) -> bytes:
        """Copy out the committed region and release it. Consumer-only."""
        t = self.tail
        h = self.head  # snapshot; producer may advance after this — fine
        n = h - t
        if n == 0:
            return b""
        lo = t & self._mask
        end = lo + n
        if end <= self.capacity:
            out = bytes(self._buf[lo:end])
        else:
            out = bytes(self._buf[lo:]) + bytes(self._buf[: end - self.capacity])
        self.tail = h  # release
        return out

    def drain_view(self) -> Tuple[memoryview, ...]:
        """Zero-copy drain: memoryview region(s) over the committed bytes.

        Returns ``()`` when empty, one region on the common path, two when the
        committed bytes straddle the physical end of the ring (records may be
        split across the pair — join before frame-parsing them).  The region
        is NOT released: the caller must finish consuming the views and then
        call :meth:`release`, or the producer could overwrite bytes still
        being read.  Consumer-only.
        """
        t = self.tail
        h = self.head  # snapshot; producer may advance after this — fine
        self._pending = h
        n = h - t
        if n == 0:
            return ()
        lo = t & self._mask
        end = lo + n
        mv = self._mv
        if end <= self.capacity:
            return (mv[lo:end],)
        return (mv[lo:], mv[: end - self.capacity])

    def release(self) -> None:
        """Release the region returned by the last :meth:`drain_view`."""
        if self._pending > self.tail:  # guard against drain()/drain_view() mixes
            self.tail = self._pending

    @property
    def used(self) -> int:
        return self.head - self.tail


class RingRegistry:
    """Tracks every thread's ring so the consumer daemon can drain them all.

    Ring creation is the only locked operation (once per thread); the event
    hot path never takes a lock — the LTTng property the paper leans on for
    its overhead numbers (Fig 7).
    """

    def __init__(self, capacity: int, pid: int):
        self._capacity = capacity
        self._pid = pid
        self._lock = threading.Lock()
        self._rings: List[RingBuffer] = []
        self._tls = threading.local()

    def get(self) -> RingBuffer:
        rb: Optional[RingBuffer] = getattr(self._tls, "ring", None)
        if rb is None:
            th = threading.current_thread()
            rb = RingBuffer(self._capacity, pid=self._pid, tid=th.ident or 0, tname=th.name)
            with self._lock:
                self._rings.append(rb)
            self._tls.ring = rb
        return rb

    def rings(self) -> List[RingBuffer]:
        with self._lock:
            return list(self._rings)

    @property
    def capacity(self) -> int:
        """Ring capacity (bytes) handed to newly-registered threads."""
        return self._capacity

    def set_capacity(self, nbytes: int) -> None:
        """Resize the capacity used for *future* rings (§6 adaptive knob).

        Existing rings keep their size — they are lock-free SPSC structures
        whose producer may be mid-write; only threads that first touch the
        registry after this call get the new capacity.
        """
        self._capacity = max(1 << 12, int(nbytes))

    @property
    def total_dropped(self) -> int:
        return sum(r.dropped for r in self.rings())

    @property
    def total_events(self) -> int:
        return sum(r.events for r in self.rings())

    def counters(self) -> dict:
        """One consistent snapshot of collection-side counters.

        ``events``/``dropped`` are cumulative producer counts; ``used`` is
        the bytes currently buffered (un-drained) across rings.  Cheap —
        one lock acquisition for the ring list, then plain reads — so mode
        conformance checks (e.g. "the off rung wrote nothing") and adaptive
        policies can poll it without perturbing producers.
        """
        rings = self.rings()
        return {
            "rings": len(rings),
            "events": sum(r.events for r in rings),
            "dropped": sum(r.dropped for r in rings),
            "used": sum(r.used() for r in rings),
        }
