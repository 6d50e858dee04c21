"""Pretty Print plugin (THAPI §3.4): human-readable event dump.

Renders each event like the paper's §1.1 example — full argument detail,
pointers in hex (``preferred_display_base: 16`` from the trace model),
metadata (timestamp, pid, tid, name):

  12:00:01.123456789 - host - vpid: 71, vtid: 71 - ust_torchrt:memcpy_entry:
      { src: 0x0000563412, dst: 0xff00abc412, nbytes: 1048576, kind: 0 }
"""

from __future__ import annotations

import io
from typing import Optional, TextIO

from ..babeltrace import CTFSource, Event
from ..clock import ClockInfo


def format_value(param, value) -> str:
    if param.display_base == 16 and isinstance(value, int):
        return f"0x{value:012x}"
    if param.cls == "bytes":
        return "0x" + bytes(value).hex() if value else "b''"
    if param.cls in ("f32", "f64"):
        return f"{value:.6g}"
    return repr(value) if isinstance(value, str) else str(value)


def format_event(ev: Event, clock: Optional[ClockInfo] = None, hostname: str = "host") -> str:
    ts = ev.ts if clock is None else clock.to_realtime(ev.ts)
    s, ns = divmod(ts, 1_000_000_000)
    fields = ", ".join(
        f"{p.name}: {format_value(p, v)}" for p, v in zip(ev.etype.fields, ev.fields)
    )
    return (
        f"{s}.{ns:09d} - {hostname} - vpid: {ev.pid}, vtid: {ev.tid} - "
        f"{ev.name}: {{ {fields} }}"
    )


def pretty_print(
    trace_dir: str,
    out: Optional[TextIO] = None,
    limit: Optional[int] = None,
    name_filter: Optional[str] = None,
) -> int:
    """Dump a trace directory; returns the number of events printed."""
    src = CTFSource(trace_dir)
    host = src.meta.env.get("hostname", "host")
    sink = out or io.StringIO()
    n = 0
    for ev in src:
        if name_filter and name_filter not in ev.name:
            continue
        sink.write(format_event(ev, src.meta.clock, host) + "\n")
        n += 1
        if limit is not None and n >= limit:
            break
    if out is None:
        print(sink.getvalue(), end="")
    return n
