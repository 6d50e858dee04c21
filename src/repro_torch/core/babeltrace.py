"""Babeltrace2-style trace processing graph (THAPI §3.4, Fig 4).

Babeltrace2 structures analysis as a graph of *source* (CTF reader), *filter*
(muxer — "serializing messages by time"), and *sink* components.  THAPI
generates its plugins from the LTTng trace model via Metababel.  We reproduce
the graph:

    CTFSource(trace_dir) ──▶ muxer ──▶ IntervalFilter ──▶ sinks
                                   └─▶ metababel.Dispatcher callbacks

Events are materialized as lightweight :class:`Event` records; entry/exit
pairs are folded into :class:`Interval` spans by the interval filter ("Interval
plugins enable detailed timing analysis based on the start and end times of
events", §3.3).
"""

from __future__ import annotations

import heapq
import operator
from typing import Dict, Iterable, Iterator, List, Tuple

from .api_model import DISCARD_EVENT_ID, EventType
from .ctf import StreamReader, TraceMeta, stream_files
from .tracepoints import Tracepoints


class Event:
    """One decoded trace event."""

    __slots__ = ("ts", "etype", "fields", "pid", "tid")

    def __init__(self, ts: int, etype: EventType, fields: tuple, pid: int, tid: int):
        self.ts = ts
        self.etype = etype
        self.fields = fields
        self.pid = pid
        self.tid = tid

    @property
    def name(self) -> str:
        return self.etype.name

    def field(self, name: str):
        for p, v in zip(self.etype.fields, self.fields):
            if p.name == name:
                return v
        raise KeyError(name)

    def asdict(self) -> dict:
        return {p.name: v for p, v in zip(self.etype.fields, self.fields)}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Event({self.name}@{self.ts} {self.asdict()})"


class Interval:
    """A folded entry/exit pair or a device span."""

    __slots__ = ("provider", "api", "ts", "dur", "pid", "tid", "entry", "exit", "device")

    def __init__(self, provider, api, ts, dur, pid, tid, entry, exit, device):
        self.provider = provider
        self.api = api
        self.ts = ts
        self.dur = dur
        self.pid = pid
        self.tid = tid
        self.entry = entry  # dict of entry fields
        self.exit = exit  # dict of exit fields (None if unmatched)
        self.device = device

    def __repr__(self):  # pragma: no cover
        return f"Interval({self.provider}:{self.api} ts={self.ts} dur={self.dur})"


# ---------------------------------------------------------------------------
# Source
# ---------------------------------------------------------------------------


class CTFSource:
    """Reads a CTF-lite trace directory into time-ordered Event streams."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.meta = TraceMeta.load(trace_dir)
        self.model = self.meta.model
        # the unpackers are generated from the trace model — the read side
        # shares its schema source with the write side (§3.3)
        self._unpack = Tracepoints(self.model).unpack
        self._etypes = self.model.events
        self.discarded = 0

    def _stream_events(self, path: str) -> Iterator[Event]:
        reader = StreamReader(path)
        unpack = self._unpack
        etypes = self._etypes
        for eid, ts, payload in reader:
            if eid >= len(etypes):
                continue  # unknown event (newer writer) — skip, don't fail
            fields = unpack[eid](payload)
            if eid == DISCARD_EVENT_ID:
                self.discarded += fields[0]
            yield Event(ts, etypes[eid], fields, reader.pid, reader.tid)

    def streams(self) -> List[Iterator[Event]]:
        return [self._stream_events(p) for p in stream_files(self.trace_dir)]

    def __iter__(self) -> Iterator[Event]:
        return muxer(self.streams())


#: C-level attribute fetch — called once per event per heap sift, so the
#: lambda→attrgetter swap is measurable on 10⁶-event merges
_TS_KEY = operator.attrgetter("ts")


def muxer(streams: Iterable[Iterator[Event]]) -> Iterator[Event]:
    """Filter component: k-way merge by timestamp (§3.4 'Muxer plugin')."""
    return heapq.merge(*streams, key=_TS_KEY)


def mux_traces(trace_dirs: Iterable[str]) -> Iterator[Event]:
    """Merge multiple ranks' trace directories into one ordered stream."""
    all_streams: List[Iterator[Event]] = []
    for d in trace_dirs:
        all_streams.extend(CTFSource(d).streams())
    return muxer(all_streams)


# ---------------------------------------------------------------------------
# Interval filter
# ---------------------------------------------------------------------------


class IntervalFilter:
    """Folds entry/exit pairs (per pid/tid call stacks) and device spans.

    Unmatched entries (application crashed mid-call, or exits dropped under
    ring-buffer pressure) surface with ``exit=None`` and ``dur=0`` so the
    validation plugin (§4.2) can flag them rather than silently dropping.
    """

    def __init__(self, events: Iterable[Event]):
        self._events = events
        self.samples: List[Event] = []  # telemetry pass-through
        self.unmatched_exits = 0

    def __iter__(self) -> Iterator[Interval]:
        stacks: Dict[Tuple[int, int, str], List[Event]] = {}
        for ev in self._events:
            et = ev.etype
            if et.phase == "span":
                d = ev.asdict()
                ts0, ts1 = d.pop("ts_begin"), d.pop("ts_end")
                yield Interval(
                    et.provider, et.api, ts0, max(0, ts1 - ts0), ev.pid, ev.tid, d, {}, True
                )
            elif et.phase == "entry":
                stacks.setdefault((ev.pid, ev.tid, et.provider + ":" + et.api), []).append(ev)
            elif et.phase == "exit":
                key = (ev.pid, ev.tid, et.provider + ":" + et.api)
                stack = stacks.get(key)
                if not stack:
                    self.unmatched_exits += 1
                    continue
                entry = stack.pop()
                yield Interval(
                    et.provider,
                    et.api,
                    entry.ts,
                    max(0, ev.ts - entry.ts),
                    ev.pid,
                    ev.tid,
                    entry.asdict(),
                    ev.asdict(),
                    False,
                )
            elif et.phase == "sample":
                self.samples.append(ev)
            # phase == "meta" (discarded counters) handled by the source
        # flush unmatched entries
        for stack in stacks.values():
            for entry in stack:
                yield Interval(
                    entry.etype.provider,
                    entry.etype.api,
                    entry.ts,
                    0,
                    entry.pid,
                    entry.tid,
                    entry.asdict(),
                    None,
                    False,
                )


def intervals_of(trace_dir: str) -> Tuple[List[Interval], List[Event], "CTFSource"]:
    """Convenience: fully materialized intervals + telemetry samples."""
    src = CTFSource(trace_dir)
    filt = IntervalFilter(iter(src))
    ivs = list(filt)
    return ivs, filt.samples, src
