"""Trace clock (THAPI §3.1).

LTTng timestamps events with a monotonic ns clock and records a realtime
offset so traces from different nodes can be aligned during the muxing phase.
We reproduce that: ``now()`` is the hot-path monotonic ns clock, and
``ClockInfo`` captures the monotonic→realtime offset once per session, stored
in the trace metadata so the Muxer (plugins/intervals/babeltrace) can align
streams from different ranks/hosts.
"""

from __future__ import annotations

import dataclasses
import time

# Hot path: a single C-level call, ~60ns. Bound at module level so generated
# tracepoints reference it directly (no attribute lookup chain).
now = time.monotonic_ns


@dataclasses.dataclass(frozen=True)
class ClockInfo:
    """Monotonic clock description persisted in trace metadata."""

    #: realtime_ns - monotonic_ns at capture; aligns streams across hosts.
    offset_ns: int
    #: monotonic timestamp when the session started (trace-local epoch).
    session_start_ns: int

    @staticmethod
    def capture() -> "ClockInfo":
        m = time.monotonic_ns()
        r = time.time_ns()
        return ClockInfo(offset_ns=r - m, session_start_ns=m)

    def to_realtime(self, ts_monotonic_ns: int) -> int:
        return ts_monotonic_ns + self.offset_ns

    def to_json(self) -> dict:
        return {"offset_ns": self.offset_ns, "session_start_ns": self.session_start_ns}

    @staticmethod
    def from_json(d: dict) -> "ClockInfo":
        return ClockInfo(offset_ns=int(d["offset_ns"]), session_start_ns=int(d["session_start_ns"]))
