"""Timeline plugin (THAPI §3.6): Perfetto-compatible visualization export.

THAPI converts traces into Perfetto's format and lays the view out as: the
host API row, the device row, then per-GPU telemetry counter rows (power,
frequency, engine utilization — Fig 5).  We emit the Chrome/Perfetto JSON
trace format (opened natively by ui.perfetto.dev):

  row 1  host API calls   (one track per traced thread)
  row 2  device spans     (pseudo-thread per device: kernels, transfers, collectives)
  rows…  counter tracks   (device memory, host RSS, host CPU%, step rate)

Complete events ("ph":"X") carry the full argument payload in ``args`` — the
rich context is preserved all the way into the visualization.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..babeltrace import CTFSource, IntervalFilter

_DEVICE_TID_BASE = 1 << 20  # pseudo-tids for device rows


def _us(ts_ns: int) -> float:
    return ts_ns / 1000.0


def timeline_events(trace_dir: str) -> List[dict]:
    src = CTFSource(trace_dir)
    filt = IntervalFilter(iter(src))
    host = src.meta.env.get("hostname", "host")
    out: List[dict] = []
    pids_seen: Dict[int, bool] = {}
    for iv in filt:
        pid = iv.pid
        if pid not in pids_seen:
            pids_seen[pid] = True
            out.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "args": {"name": f"Hostname {host} Process {pid}"},
                }
            )
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": _DEVICE_TID_BASE,
                    "args": {"name": "Device 0"},
                }
            )
        tid = _DEVICE_TID_BASE if iv.device else iv.tid
        args = dict(iv.entry)
        if iv.exit:
            args.update(iv.exit)
        dev_name = args.get("name", iv.api) if iv.device else None
        out.append(
            {
                "ph": "X",
                "name": f"{iv.provider}:{iv.api}" if not iv.device else dev_name,
                "cat": iv.provider,
                "pid": pid,
                "tid": tid,
                "ts": _us(iv.ts),
                "dur": max(_us(iv.dur), 0.001),
                "args": {k: (v if not isinstance(v, bytes) else v.hex()) for k, v in args.items()},
            }
        )
    # counter rows (Fig 5's telemetry rows)
    counters = (
        ("mem_in_use", "Device Memory In Use"),
        ("mem_peak", "Device Memory Peak"),
        ("host_rss", "Host RSS"),
        ("host_cpu_pct", "Host CPU (%)"),
        ("step_rate", "Step Rate (steps/s)"),
    )
    for ev in filt.samples:
        d = ev.asdict()
        for key, label in counters:
            out.append(
                {
                    "ph": "C",
                    "name": label,
                    "pid": ev.pid,
                    "ts": _us(ev.ts),
                    "args": {label: d.get(key, 0)},
                }
            )
    out.sort(key=lambda e: e.get("ts", 0))
    return out


def write_timeline(trace_dir: str, out_path: str) -> int:
    """Write Perfetto-loadable JSON; returns the number of trace events."""
    events = timeline_events(trace_dir)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns"}, f)
    return len(events)


# ---------------------------------------------------------------------------
# Interval queries (zoom/window reads) — columnar fast path
# ---------------------------------------------------------------------------

#: one queried interval: (ts, dur, pid, tid, name, device)
IntervalRow = tuple


def _overlaps(ts: int, dur: int, begin, end) -> bool:
    """Closed-start overlap with [begin, end): zero-duration intervals on the
    window's begin edge are included (flushed unmatched entries stay
    visible when zooming to their timestamp)."""
    if end is not None and ts >= end:
        return False
    if begin is not None and ts + dur < begin:
        return False
    return True


def _graph_intervals(trace_dir: str):
    """Reference/record-parse path: the full Babeltrace-style graph."""
    src = CTFSource(trace_dir)
    for iv in IntervalFilter(iter(src)):
        if iv.device:
            # per-kernel naming mirrors the tally: only launch spans key on
            # the payload name; other spans keep their API name
            name = iv.entry.get("name", iv.api) if iv.api == "launch" else iv.api
        else:
            name = f"{iv.provider}:{iv.api}"
        yield (iv.ts, iv.dur, iv.pid, iv.tid, name, iv.device)


def _sidecar_intervals(trace_dir: str, sidecars):
    """Columnar path: derive intervals from (ts, eid, dur, pair) columns —
    no record parsing, no payload unpacking (names come from the footer
    name table)."""
    from ..ctf import NO_PAIR, TraceMeta
    from ..fold import K_ENTRY, K_EXIT, FoldPlan

    meta = TraceMeta.load(trace_dir)
    plan_rows = FoldPlan(meta.model).rows
    nplans = len(plan_rows)
    events = meta.model.events
    for pid, tid, sc in sidecars:
        ts, en, dur, pair = sc.columns()
        names = sc.footer.get("names", [])
        for i in range(sc.rows):
            e = en[i]
            eid = e & 0xFFFF
            if eid >= nplans:
                continue
            kind = plan_rows[eid][0]
            if kind == K_EXIT:
                j = pair[i]
                if j == NO_PAIR:
                    continue  # unmatched exit: no interval (graph parity)
                ev = events[eid]
                yield (ts[j], dur[i], pid, tid, f"{ev.provider}:{ev.api}", False)
            elif kind == K_ENTRY:
                if pair[i] == NO_PAIR:  # unmatched entry: zero-duration flush
                    ev = events[eid]
                    yield (ts[i], 0, pid, tid, f"{ev.provider}:{ev.api}", False)
            else:  # span kinds — the only other row-producing kinds
                nid = e >> 16
                name = names[nid - 1] if nid else events[eid].api
                yield (ts[i], dur[i], pid, tid, name, True)


def query_intervals(
    trace_dir: str,
    begin=None,
    end=None,
    use_sidecar: bool = True,
) -> List[IntervalRow]:
    """Time-window interval query: ``(ts, dur, pid, tid, name, device)``
    rows overlapping ``[begin, end)``, sorted deterministically.

    When every stream carries a valid columnar sidecar (and no two streams
    share a ``(pid, tid)``), the query walks the packed columns and never
    parses a record; otherwise — any sidecar missing, stale, or of an
    unknown version — it transparently falls back to the record-parse graph
    path.  Both paths return identical rows (``tests/test_columnar.py``).
    """
    from ..ctf import load_sidecar, stream_files
    from ..ctf import StreamReader as _SR

    rows = None
    if use_sidecar:
        sidecars = []
        seen = set()
        for path in stream_files(trace_dir):
            r = _SR(path)
            sc = load_sidecar(path)
            if sc is None or (r.pid, r.tid) in seen:
                sidecars = None  # incomplete coverage: fall back wholesale
                break
            seen.add((r.pid, r.tid))
            sidecars.append((r.pid, r.tid, sc))
        if sidecars is not None:
            rows = _sidecar_intervals(trace_dir, sidecars)
    if rows is None:
        rows = _graph_intervals(trace_dir)
    out = [r for r in rows if _overlaps(r[0], r[1], begin, end)]
    out.sort(key=lambda r: (r[0], r[1], str(r[4]), r[2], r[3]))
    return out
