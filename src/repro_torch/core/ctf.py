"""CTF-lite: compact binary trace streams + JSON metadata (THAPI §3.1, §3.4).

LTTng writes Common Trace Format: binary event streams described by a
metadata document, parsed post-mortem by Babeltrace2.  We reproduce the
shape: a trace is a *directory* containing

    metadata.json            trace model + clock + environment (≙ CTF TSDL)
    stream_<pid>_<tid>.ctf   one binary stream per producer ring
    stream_<pid>_<tid>.ctfcol  optional columnar sidecar (see below)
    <prefix>...              multiple ranks may share a dir with rank prefixes

Stream layout: 16-byte magic/version header, then packets of framed records
exactly as produced by the ring buffers (ringbuffer.RECORD_HEADER framing).
The consumer daemon appends ring drains verbatim — zero re-encoding on the
write path, which is how LTTng keeps the consumer cheap.

Discarded events are materialized as ``ctf:events_discarded`` records
(event id 0) whenever the consumer observes a ring's drop counter advance —
the CTF discarded-events counter made explicit.

Columnar sidecar (the Anderson-et-al. "scalable trace format" argument):
when ``TraceConfig.columnar`` is on (or ``iprof index`` is run post-hoc),
each stream gains a ``.ctfcol`` sidecar holding the analysis-relevant view
of its records as four contiguous packed-u64 columns — interval timestamp,
event id (kernel-name table index packed in the high bits), duration, and
pair link (row index of the matching entry/exit) — plus a JSON footer that
carries the per-stream folded tally, the kernel-name table, and the exact
stream byte count the sidecar was built against.  Analysis that trusts a
sidecar never parses records: ``fold_trace`` reads the footer tally,
timeline interval queries walk the columns.  Trust is strict: wrong magic,
unknown version, structural mismatch, or a stream whose on-disk size no
longer equals ``stream_bytes`` (truncated tail, appended records) all make
``load_sidecar`` return ``None`` and analysis falls back to record parsing
— the sidecar is a cache, never a source of truth.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Iterator, List, Optional, Tuple

from .api_model import DISCARD_EVENT_ID, TraceModel
from .clock import ClockInfo
from .ringbuffer import RECORD_HEADER, RECORD_HEADER_SIZE

MAGIC = b"THAPIctf"  # 8 bytes
VERSION = 1
STREAM_HEADER = struct.Struct("<8sII")  # magic, version, reserved

METADATA_FILE = "metadata.json"


# ---------------------------------------------------------------------------
# Write side
# ---------------------------------------------------------------------------


class _ZlibStreamWriter:
    """stdlib fallback container used when ``zstandard`` is not installed."""

    def __init__(self, f, level: int = 6):
        import zlib

        self._c = zlib.compressobj(level)
        self._f = f

    def write(self, b) -> None:
        self._f.write(self._c.compress(bytes(b)))

    def finish(self) -> None:
        self._f.write(self._c.flush())


class StreamWriter:
    """One binary stream (one ring → one file).

    ``compress=True`` writes a compressed frame around the stream (the Fig 8
    space knob taken further: CTF stays the inner format; the container is
    zstd when available, zlib otherwise — readers sniff the frame magic).
    """

    def __init__(self, path: str, pid: int, tid: int, compress: bool = False):
        self.path = path
        self.pid = pid
        self.tid = tid
        self.compress = compress
        self._f = open(path, "wb", buffering=1 << 16)
        if compress:
            try:
                import zstandard as zstd

                self._zw = zstd.ZstdCompressor(level=3).stream_writer(self._f)
                self._finish = lambda: self._zw.flush(zstd.FLUSH_FRAME)
            except ImportError:
                self._zw = _ZlibStreamWriter(self._f)
                self._finish = self._zw.finish
            self._out = self._zw
        else:
            self._zw = None
            self._finish = None
            self._out = self._f
        self._out.write(STREAM_HEADER.pack(MAGIC, VERSION, 0))
        #: drop count already materialized as discard records; the consumer
        #: compares against the ring's live counter to skip no-op calls
        self.seen_dropped = 0
        self.bytes_written = STREAM_HEADER.size

    def append(self, chunk) -> None:
        """Append raw framed-record bytes — accepts any bytes-like object.

        The zero-copy drain hands ``memoryview`` regions straight from ring
        storage; the buffered file object copies them out during ``write``,
        so the view may be released as soon as this returns.
        """
        if chunk:
            self._out.write(chunk)
            self.bytes_written += len(chunk)

    def note_drops(self, total_dropped: int, ts_ns: int) -> None:
        """Emit a ctf:events_discarded record if the drop counter advanced."""
        delta = total_dropped - self.seen_dropped
        if delta > 0:
            payload = struct.pack("<Q", delta)
            rec = RECORD_HEADER.pack(
                RECORD_HEADER_SIZE + len(payload), DISCARD_EVENT_ID, ts_ns
            ) + payload
            self._out.write(rec)
            self.bytes_written += len(rec)
            self.seen_dropped = total_dropped

    def close(self) -> None:
        if not self._f.closed:
            if self._finish is not None:
                self._finish()
            self._f.flush()
            self._f.close()


def write_metadata(
    trace_dir: str,
    model: TraceModel,
    clock: ClockInfo,
    env: Optional[dict] = None,
    mode: str = "default",
) -> None:
    doc = {
        "format": "thapi-ctf-lite",
        "version": VERSION,
        "mode": mode,
        "clock": clock.to_json(),
        "env": env or {},
        "events": model.to_json(),
    }
    tmp = os.path.join(trace_dir, METADATA_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, os.path.join(trace_dir, METADATA_FILE))


# ---------------------------------------------------------------------------
# Read side (consumed by the Babeltrace-style source component)
# ---------------------------------------------------------------------------


class TraceMeta:
    def __init__(self, doc: dict):
        self.doc = doc
        self.model = TraceModel.from_json(doc["events"])
        self.clock = ClockInfo.from_json(doc["clock"])
        self.mode: str = doc.get("mode", "default")
        self.env: dict = doc.get("env", {})

    @staticmethod
    def load(trace_dir: str) -> "TraceMeta":
        with open(os.path.join(trace_dir, METADATA_FILE)) as f:
            return TraceMeta(json.load(f))


#: (eid, ts_ns, payload) — payload is a memoryview into the stream buffer.
RawEvent = Tuple[int, int, memoryview]

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _decompress(blob: bytes) -> bytes:
    """A compressed stream's bytes: its one compressed frame (``StreamWriter``
    closes it at ``close()``), then whatever follows the frame as raw framed
    records — records appended to the file after it was written, which a
    stale sidecar's byte count also sees.  A truncated frame yields what it
    holds, as a torn plain stream does."""
    if blob[:4] == _ZSTD_MAGIC:
        import zstandard as zstd

        d = zstd.ZstdDecompressor().decompressobj()
    else:
        import zlib

        d = zlib.decompressobj()
    out = d.decompress(blob)
    return out + d.unused_data if d.eof else out


class StreamReader:
    """Iterates framed records of one stream file.

    Uncompressed streams are mapped (``mmap``) rather than read into a heap
    buffer — the analysis side of a 10⁷-event trace then walks page-cache
    memory directly, with one ``memoryview`` over the whole record region
    (``records_region``) instead of a Python-bytes copy of the file.
    Compressed streams (zstd/zlib containers) decompress into one buffer and
    take the same code path.
    """

    def __init__(self, path: str):
        self.path = path
        base = os.path.basename(path)
        # stream_<pid>_<tid>.ctf, possibly with a rank prefix
        stem = base[: -len(".ctf")] if base.endswith(".ctf") else base
        parts = stem.split("_")
        try:
            self.pid, self.tid = int(parts[-2]), int(parts[-1])
        except (ValueError, IndexError):
            self.pid, self.tid = 0, 0

    def _load(self) -> Tuple[memoryview, Callable[[], None]]:
        """(whole-stream buffer, release) — mmap-backed when uncompressed."""
        with open(self.path, "rb") as f:
            head = f.read(4)
            if head[:4] == _ZSTD_MAGIC or head[:1] == b"\x78":  # zstd / zlib (MAGIC starts with 'T')
                f.seek(0)
                return memoryview(_decompress(f.read())), lambda: None
            import mmap

            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except (ValueError, OSError):  # empty file or exotic fs: plain read
                f.seek(0)
                raw = f.read()
                return memoryview(raw), lambda: None
        # the mapping outlives the (now closed) fd
        mv = memoryview(mm)

        def release(mv=mv, mm=mm) -> None:
            mv.release()
            try:
                mm.close()
            except BufferError:  # a sliced view still exported — GC will close
                pass

        return mv, release

    def records_region(self) -> Tuple[memoryview, Callable[[], None]]:
        """Validated record region (past the stream header) + release callable.

        The batched-scan entry point used by the fold engine: callers walk
        ``RECORD_HEADER``-framed records over one buffer with zero per-record
        allocation.  An empty/too-short stream yields an empty view.
        """
        mv, release = self._load()
        if len(mv) < STREAM_HEADER.size:
            return mv[0:0], release
        magic, version, _ = STREAM_HEADER.unpack_from(mv)
        if magic != MAGIC:
            release()
            raise ValueError(f"{self.path}: not a THAPI ctf-lite stream")
        if version != VERSION:
            release()
            raise ValueError(f"{self.path}: unsupported version {version}")
        return mv[STREAM_HEADER.size :], release

    def __iter__(self) -> Iterator[RawEvent]:
        data, release = self.records_region()
        try:
            off, n = 0, len(data)
            while off + RECORD_HEADER_SIZE <= n:
                total, eid, ts = RECORD_HEADER.unpack_from(data, off)
                if total < RECORD_HEADER_SIZE or off + total > n:
                    break  # truncated tail (e.g. crash mid-write) — stop cleanly
                yield eid, ts, data[off + RECORD_HEADER_SIZE : off + total]
                off += total
        finally:
            release()


def stream_files(trace_dir: str) -> List[str]:
    out = []
    for name in sorted(os.listdir(trace_dir)):
        if name.endswith(".ctf"):
            out.append(os.path.join(trace_dir, name))
    return out


def trace_size_bytes(trace_dir: str) -> int:
    return sum(os.path.getsize(p) for p in stream_files(trace_dir))


# ---------------------------------------------------------------------------
# Columnar sidecar (.ctfcol): per-stream packed-u64 columns + JSON footer
# ---------------------------------------------------------------------------

COL_MAGIC = b"THAPIcol"  # 8 bytes, distinct from the stream MAGIC
COL_VERSION = 1
COL_HEADER = struct.Struct("<8sII")  # magic, version, reserved
_COL_COUNT = struct.Struct("<Q")
_COL_FLEN = struct.Struct("<I")
N_COLUMNS = 4  # ts, eid+name, duration, pair link

#: pair-link / "no link" sentinel in the pair column
NO_PAIR = (1 << 64) - 1


def sidecar_path(stream_path: str) -> str:
    """``stream_<pid>_<tid>.ctf`` → ``stream_<pid>_<tid>.ctfcol``."""
    if stream_path.endswith(".ctf"):
        return stream_path + "col"
    return stream_path + ".ctfcol"


def _le_u64s(a) -> bytes:
    """array('Q') → little-endian bytes regardless of host byte order."""
    import sys as _sys

    if _sys.byteorder != "little":
        a = a[:]
        a.byteswap()
    return a.tobytes()


class ColumnarWriter:
    """Builds one stream's ``.ctfcol`` sidecar from drained record chunks.

    Fed the exact framed-record bytes the :class:`StreamWriter` receives
    (the tracer's zero-copy drain memoryviews, or a whole-stream
    ``records_region`` when indexing post-hoc).  Two derived views are
    maintained per chunk:

      * the **folded tally** — every chunk goes through the shared
        :class:`~repro_torch.core.fold.FoldEngine`, so the footer tally is
        *by construction* what a record-parse fold of the stream produces
        (identical pairing, clamping, unmatched and discard semantics);
      * the **interval columns** — one row per analysis-relevant record
        (entries, exits, device spans; samples/discards/unknown eids
        contribute nothing a query reads and get no row):

          ts    u64  interval-semantic timestamp: header ts for entry/exit
                     records, payload ``ts_begin`` for spans
          eid   u64  low 16 bits: event id; high bits: 1 + index into the
                     footer name table for named launch spans (0 = unnamed)
          dur   u64  completed-interval duration (on exit and span rows)
          pair  u64  row index of the matching entry (on exits) / exit (on
                     entries); NO_PAIR when unmatched or not a pair event

    ``close(stream_bytes)`` flushes unmatched entries through the engine
    (mirroring the offline fold) and writes the file atomically.
    """

    def __init__(self, engine, pid: int, tid: int, path: str):
        # engine is a repro_torch.core.fold.FoldEngine (imported lazily by callers:
        # fold.py imports this module, so ctf cannot import fold at top level)
        from array import array

        self.engine = engine
        self.pid = pid
        self.tid = tid
        self.path = path
        self.state = engine.new_state()
        self.ts = array("Q")
        self.en = array("Q")
        self.dur = array("Q")
        self.pair = array("Q")
        self._stacks: dict = {}  # pair_id → [row indexes of open entries]
        self._names: list = []  # kernel-name table (footer)
        self._nids: dict = {}  # name → table index

    def append(self, chunk) -> None:
        """Index one framed-record chunk (and fold it into the tally)."""
        self.engine.fold_chunk(self.state, chunk, self.pid, self.tid)
        self._index_chunk(chunk)

    def note_discard(self, count: int) -> None:
        """Account discard records the consumer writes straight to the stream
        (``StreamWriter.note_drops`` bytes never pass through ``append``)."""
        self.state.discarded += count

    def _name_id(self, name) -> int:
        nid = self._nids.get(name)
        if nid is None:
            nid = self._nids[name] = len(self._names)
            self._names.append(name)
        return nid

    def _index_chunk(self, buf) -> None:
        # mirrors FoldEngine.fold_chunk's walk (same skip rules, so a row
        # exists exactly when the fold read the record) with column output
        from .fold import (
            K_ENTRY,
            K_EXIT,
            K_SPAN,
            K_SPAN_NAMED,
            K_SPAN_NAMED_GENERIC,
            _LEN,
            _SPAN_TS,
        )

        if type(buf) is not memoryview:
            buf = memoryview(buf)
        plan_rows = self.engine.plan.rows
        nplans = len(plan_rows)
        hdr_unpack = RECORD_HEADER.unpack_from
        col_ts, col_en, col_dur, col_pair = self.ts, self.en, self.dur, self.pair
        stacks = self._stacks
        off = 0
        n = len(buf)
        limit = n - RECORD_HEADER_SIZE
        while off <= limit:
            total, eid, ts = hdr_unpack(buf, off)
            if total < RECORD_HEADER_SIZE or off + total > n:
                break  # truncated tail
            rec_end = off + total
            if eid < nplans:
                kind, key, aid, noff, _ = plan_rows[eid]
                if kind == K_ENTRY:
                    stack = stacks.get(aid)
                    if stack is None:
                        stack = stacks[aid] = []
                    stack.append(len(col_ts))
                    col_ts.append(ts)
                    col_en.append(eid)
                    col_dur.append(0)
                    col_pair.append(NO_PAIR)
                elif kind == K_EXIT:
                    stack = stacks.get(aid)
                    row = len(col_ts)
                    if stack:
                        eidx = stack.pop()
                        d = ts - col_ts[eidx]
                        if d < 0:
                            d = 0
                        col_pair[eidx] = row
                        col_ts.append(ts)
                        col_en.append(eid)
                        col_dur.append(d)
                        col_pair.append(eidx)
                    else:  # unmatched exit: row kept, contributes no interval
                        col_ts.append(ts)
                        col_en.append(eid)
                        col_dur.append(0)
                        col_pair.append(NO_PAIR)
                elif kind in (K_SPAN, K_SPAN_NAMED, K_SPAN_NAMED_GENERIC):
                    poff = off + RECORD_HEADER_SIZE
                    if poff + 16 > rec_end:  # short payload: fold skipped it
                        off = rec_end
                        continue
                    t0, t1 = _SPAN_TS.unpack_from(buf, poff)
                    d = t1 - t0
                    if d < 0:
                        d = 0
                    nid = 0
                    if kind == K_SPAN_NAMED:
                        nb_off = poff + noff
                        if nb_off + 4 > rec_end:
                            off = rec_end
                            continue
                        (ln,) = _LEN.unpack_from(buf, nb_off)
                        if nb_off + 4 + ln > rec_end:
                            off = rec_end
                            continue
                        name = bytes(buf[nb_off + 4 : nb_off + 4 + ln]).decode(
                            errors="replace"
                        )
                        nid = 1 + self._name_id(name)
                    elif kind == K_SPAN_NAMED_GENERIC:
                        try:
                            name = self.engine._unpack[eid](buf[poff:rec_end])[noff]
                        except struct.error:
                            off = rec_end
                            continue
                        if type(name) is not str:  # footer table is JSON
                            name = str(name)
                        nid = 1 + self._name_id(name)
                    col_ts.append(t0)
                    col_en.append(eid | (nid << 16))
                    col_dur.append(d)
                    col_pair.append(NO_PAIR)
                # K_SKIP / K_DISCARD: nothing a query reads — no row
            off = rec_end

    def close(self, stream_bytes: int) -> None:
        """Finalize: flush unmatched entries into the footer tally and write
        the sidecar atomically (readers see a complete file or none)."""
        tally = self.engine.finish(self.state)
        footer = {
            "format": "thapi-ctf-col",
            "version": COL_VERSION,
            "rows": len(self.ts),
            "stream_bytes": int(stream_bytes),
            "names": self._names,
            "tally": tally.to_obj(),
            "events_seen": self.state.events_seen,
        }
        fb = json.dumps(footer, sort_keys=True).encode()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(COL_HEADER.pack(COL_MAGIC, COL_VERSION, 0))
            f.write(_COL_COUNT.pack(len(self.ts)))
            for col in (self.ts, self.en, self.dur, self.pair):
                f.write(_le_u64s(col))
            f.write(fb)
            f.write(_COL_FLEN.pack(len(fb)))
        os.replace(tmp, self.path)


class ColumnarSidecar:
    """A validated, loaded ``.ctfcol`` sidecar (see :func:`load_sidecar`)."""

    __slots__ = ("path", "rows", "footer")

    def __init__(self, path: str, rows: int, footer: dict):
        self.path = path
        self.rows = rows
        self.footer = footer

    def tally(self):
        """The per-stream folded tally recorded in the footer."""
        from .plugins.tally import Tally

        return Tally.from_obj(self.footer["tally"])

    def columns(self) -> tuple:
        """(ts, eid+name, dur, pair) as array('Q') columns."""
        import sys as _sys
        from array import array

        out = []
        with open(self.path, "rb") as f:
            f.seek(COL_HEADER.size + _COL_COUNT.size)
            for _ in range(N_COLUMNS):
                a = array("Q")
                a.frombytes(f.read(8 * self.rows))
                if _sys.byteorder != "little":
                    a.byteswap()
                out.append(a)
        return tuple(out)


def load_sidecar(stream_path: str) -> Optional[ColumnarSidecar]:
    """Load and validate the sidecar for one stream, or None.

    None (→ callers fall back to record parsing) whenever the sidecar is
    missing, carries an unknown magic/version (forward compatibility: newer
    formats are skipped, never crashed on), is structurally inconsistent, or
    is **stale** — the stream's current on-disk byte count differs from the
    ``stream_bytes`` the sidecar was built against (truncation or append).
    """
    path = sidecar_path(stream_path)
    try:
        fsize = os.path.getsize(path)
        with open(path, "rb") as f:
            head_len = COL_HEADER.size + _COL_COUNT.size
            if fsize < head_len + _COL_FLEN.size:
                return None
            magic, version, _ = COL_HEADER.unpack(f.read(COL_HEADER.size))
            if magic != COL_MAGIC or version != COL_VERSION:
                return None
            (rows,) = _COL_COUNT.unpack(f.read(_COL_COUNT.size))
            base = head_len + 8 * N_COLUMNS * rows
            if fsize < base + _COL_FLEN.size:
                return None
            f.seek(fsize - _COL_FLEN.size)
            (flen,) = _COL_FLEN.unpack(f.read(_COL_FLEN.size))
            if base + flen + _COL_FLEN.size != fsize:
                return None
            f.seek(base)
            footer = json.loads(f.read(flen))
        stream_size = os.path.getsize(stream_path)
    except (OSError, ValueError, struct.error):
        return None
    if not isinstance(footer, dict) or "tally" not in footer:
        return None
    if footer.get("version") != COL_VERSION:
        return None
    if footer.get("stream_bytes") != stream_size:
        return None  # stale: stream truncated or grew since indexing
    return ColumnarSidecar(path, rows, footer)


def build_sidecars(trace_dir: str) -> int:
    """Index an existing trace post-hoc: write/refresh a ``.ctfcol`` sidecar
    for every stream (``iprof index``).  Returns the stream count."""
    from .fold import FoldEngine

    meta = TraceMeta.load(trace_dir)
    engine = FoldEngine(meta.model)
    n = 0
    for path in stream_files(trace_dir):
        reader = StreamReader(path)
        cw = ColumnarWriter(engine, reader.pid, reader.tid, sidecar_path(path))
        buf, release = reader.records_region()
        try:
            cw.append(buf)
        finally:
            release()
        cw.close(os.path.getsize(path))
        n += 1
    return n
