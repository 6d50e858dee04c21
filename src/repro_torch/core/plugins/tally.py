"""Tally plugin (THAPI §3.4, §4.3): per-API summary tables.

Produces the paper's table: per API call — total time, share, call count,
average/min/max — grouped under backend headers, plus the hostname/process/
thread counts banner.  Tallies are *mergeable monoids*, which is what makes
the §3.7 aggregation tree (local master → global master) possible.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..babeltrace import CTFSource, Interval, IntervalFilter

#: interned (provider, api) key tuples — the row keys of every tally in the
#: process.  Analysis folds, merges, and delta application all funnel their
#: keys through :func:`intern_key`, so a 2000-row tally merged across 1000
#: ranks reuses 2000 tuple objects instead of allocating per row per merge
#: (and identity-equal keys let dict lookups short-circuit on pointer
#: comparison before falling back to string equality).  Capped: a long-lived
#: master fed unbounded key cardinality (e.g. shape-specialized kernel names
#: across many jobs) must not pin every key it ever saw — past the cap, keys
#: are returned uninterned (correctness is unaffected; only sharing stops).
_KEY_INTERN: Dict[Tuple[str, str], Tuple[str, str]] = {}
_KEY_INTERN_MAX = 1 << 16


def intern_key(provider: str, api: str) -> Tuple[str, str]:
    """Canonical shared (provider, api) tuple for tally row keys."""
    key = (provider, api)
    cached = _KEY_INTERN.get(key)
    if cached is not None:
        return cached
    if len(_KEY_INTERN) < _KEY_INTERN_MAX:
        _KEY_INTERN[key] = key
    return key


@dataclasses.dataclass
class ApiStat:
    calls: int = 0
    total_ns: int = 0
    min_ns: int = 2**63 - 1
    max_ns: int = 0

    def add(self, dur_ns: int) -> None:
        self.calls += 1
        self.total_ns += dur_ns
        if dur_ns < self.min_ns:
            self.min_ns = dur_ns
        if dur_ns > self.max_ns:
            self.max_ns = dur_ns

    def merge(self, other: "ApiStat") -> None:
        self.calls += other.calls
        self.total_ns += other.total_ns
        self.min_ns = min(self.min_ns, other.min_ns)
        self.max_ns = max(self.max_ns, other.max_ns)

    @property
    def avg_ns(self) -> float:
        return self.total_ns / self.calls if self.calls else 0.0


@dataclasses.dataclass
class Tally:
    #: (provider, api) → stats
    apis: Dict[Tuple[str, str], ApiStat] = dataclasses.field(default_factory=dict)
    hostnames: Set[str] = dataclasses.field(default_factory=set)
    processes: Set[int] = dataclasses.field(default_factory=set)
    threads: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)
    discarded: int = 0
    #: device-side totals (kernel/transfer spans) kept separately, like the
    #: paper's host vs device timeline rows
    device_apis: Dict[Tuple[str, str], ApiStat] = dataclasses.field(default_factory=dict)
    #: host rows are scaled 1/N-sampling estimates (see :meth:`scale`) — the
    #: renderer marks them, merges propagate the flag
    estimated: bool = False
    #: sampling interval behind the estimates (display only; 1 = exact)
    sample_interval: int = 1

    def scale(self, n: int) -> "Tally":
        """Apply the 1/N systematic-sampling estimator to the host rows.

        Every host ``apis`` row originates from an entry/exit pair, and the
        sampled tier gates exactly those — so scaling calls and total
        durations by N yields the unbiased estimate (uniform random phase ⇒
        each call is selected with probability exactly 1/N).  ``min``/``max``
        are observed extrema of the sample and stay unscaled; device spans
        and counter samples are never gated, so ``device_apis`` stays exact.
        """
        for st in self.apis.values():
            st.calls *= n
            st.total_ns *= n
        self.estimated = True
        self.sample_interval = n
        return self

    def add_interval(self, iv: Interval) -> None:
        table = self.device_apis if iv.device else self.apis
        api = iv.api
        if iv.device and iv.api == "launch":
            # kernel spans tally per kernel name (the paper's per-API rows)
            api = iv.entry.get("name", iv.api)
        key = intern_key(iv.provider, api)
        st = table.get(key)
        if st is None:
            st = table[key] = ApiStat()
        st.add(iv.dur)
        self.processes.add(iv.pid)
        self.threads.add((iv.pid, iv.tid))

    def merge(self, other: "Tally") -> "Tally":
        for key, st in other.apis.items():
            mine = self.apis.get(key)
            if mine is None:
                self.apis[key] = dataclasses.replace(st)
            else:
                mine.merge(st)
        for key, st in other.device_apis.items():
            mine = self.device_apis.get(key)
            if mine is None:
                self.device_apis[key] = dataclasses.replace(st)
            else:
                mine.merge(st)
        self.hostnames |= other.hostnames
        self.processes |= other.processes
        self.threads |= other.threads
        self.discarded += other.discarded
        if other.estimated:
            self.estimated = True
            self.sample_interval = max(self.sample_interval, other.sample_interval)
        return self

    # -- (de)serialization for the aggregation tree --------------------------
    def to_obj(self) -> dict:
        def enc(t):
            return [
                [p, a, s.calls, s.total_ns, s.min_ns, s.max_ns] for (p, a), s in t.items()
            ]

        out = {
            "apis": enc(self.apis),
            "device_apis": enc(self.device_apis),
            "hostnames": sorted(self.hostnames),
            "processes": sorted(self.processes),
            "threads": sorted(list(t) for t in self.threads),
            "discarded": self.discarded,
        }
        if self.estimated:  # omitted when exact: wire compat with old readers
            out["estimated"] = True
            out["sample_interval"] = self.sample_interval
        return out

    @staticmethod
    def from_obj(d: dict) -> "Tally":
        def dec(items):
            return {
                intern_key(p, a): ApiStat(calls=c, total_ns=t, min_ns=mn, max_ns=mx)
                for p, a, c, t, mn, mx in items
            }

        return Tally(
            apis=dec(d["apis"]),
            device_apis=dec(d["device_apis"]),
            hostnames=set(d["hostnames"]),
            processes=set(d["processes"]),
            threads={tuple(t) for t in d["threads"]},
            discarded=int(d["discarded"]),
            estimated=bool(d.get("estimated", False)),
            sample_interval=int(d.get("sample_interval", 1)),
        )

    # -- delta encoding for the streaming protocol (v2) -----------------------
    def delta_to(self, prev: "Tally") -> dict:
        """Encode the change from ``prev`` (an older cumulative state of this
        same tally) as a delta object for the v2 streaming protocol.

        Cumulative tallies only grow: API entries accumulate, sets gain
        members, keys never disappear.  A delta therefore carries the *full
        cumulative value* of every changed or new entry (so applying it is a
        per-key replace, not an add — idempotent for a given seq) plus only
        the newly-seen set members.  ``discarded`` is shipped cumulatively.

        Raises ``ValueError`` if ``prev`` is not a prefix of this tally (an
        API entry or set member present in ``prev`` but missing here) — the
        delta format cannot express removal, and callers must fall back to a
        full snapshot.
        """

        def enc_changed(cur, old, label):
            if old.keys() - cur.keys():
                raise ValueError(f"delta cannot express removed {label} entries")
            out = []
            for key, st in cur.items():
                ps = old.get(key)
                if ps is None or (
                    ps.calls != st.calls
                    or ps.total_ns != st.total_ns
                    or ps.min_ns != st.min_ns
                    or ps.max_ns != st.max_ns
                ):
                    out.append([key[0], key[1], st.calls, st.total_ns, st.min_ns, st.max_ns])
            return out

        for cur_set, old_set, label in (
            (self.hostnames, prev.hostnames, "hostnames"),
            (self.processes, prev.processes, "processes"),
            (self.threads, prev.threads, "threads"),
        ):
            if old_set - cur_set:
                raise ValueError(f"delta cannot express removed {label}")
        out = {
            "apis": enc_changed(self.apis, prev.apis, "apis"),
            "device_apis": enc_changed(self.device_apis, prev.device_apis, "device_apis"),
            "hostnames": sorted(self.hostnames - prev.hostnames),
            "processes": sorted(self.processes - prev.processes),
            "threads": sorted(list(t) for t in self.threads - prev.threads),
            "discarded": self.discarded,
        }
        if self.estimated:
            out["estimated"] = True
            out["sample_interval"] = self.sample_interval
        return out

    def apply_delta(self, d: dict) -> "Tally":
        """Apply a delta produced by :meth:`delta_to` against this tally.

        Listed API entries carry cumulative values, so application replaces
        them key-by-key; set members and the discarded count are merged in.
        Only valid when this tally is exactly the base state the delta was
        computed against (the streaming layer enforces that with seq /
        base_seq numbering). Returns ``self``.
        """
        for p, a, c, t, mn, mx in d["apis"]:
            self.apis[intern_key(p, a)] = ApiStat(
                calls=c, total_ns=t, min_ns=mn, max_ns=mx
            )
        for p, a, c, t, mn, mx in d["device_apis"]:
            self.device_apis[intern_key(p, a)] = ApiStat(
                calls=c, total_ns=t, min_ns=mn, max_ns=mx
            )
        self.hostnames |= set(d["hostnames"])
        self.processes |= set(d["processes"])
        self.threads |= {tuple(t) for t in d["threads"]}
        self.discarded = int(d["discarded"])
        if d.get("estimated"):
            self.estimated = True
            self.sample_interval = max(self.sample_interval, int(d.get("sample_interval", 1)))
        return self


def tally_intervals(intervals: Iterable[Interval], hostname: str = "") -> Tally:
    t = Tally()
    if hostname:
        t.hostnames.add(hostname)
    for iv in intervals:
        t.add_interval(iv)
    return t


def tally_trace(
    trace_dir: str,
    legacy_graph: bool = False,
    jobs: int = 1,
    use_sidecar: bool = True,
) -> Tally:
    """Tally a CTF-lite trace directory.

    Default: the single-pass fold engine (``core/fold.py``) — no Event/
    Interval materialization, no global time-sort, ~an order of magnitude
    faster on large traces.  ``jobs`` shards the fold across worker
    processes (``jobs=None`` = one per CPU; identical result for every job
    count), and ``use_sidecar`` lets validated ``.ctfcol`` columnar
    sidecars short-circuit record parsing entirely.  ``legacy_graph=True``
    is the escape hatch that routes through the full Babeltrace-style graph
    (CTFSource → IntervalFilter → tally_intervals), single-process and
    sidecar-blind; all paths produce identical tallies (property-tested in
    ``tests/test_fold.py`` and ``tests/test_parallel_fold.py``).
    """
    if not legacy_graph:
        from ..fold import fold_trace  # deferred: fold imports this module

        return fold_trace(trace_dir, jobs=jobs, use_sidecar=use_sidecar)
    src = CTFSource(trace_dir)
    filt = IntervalFilter(iter(src))
    t = tally_intervals(filt)
    t.discarded = src.discarded
    host = src.meta.env.get("hostname", "")
    if host:
        t.hostnames.add(host)
    # mirror fold_trace's sampled-session estimator so every analysis path
    # reports the same (scaled) tally for a pure-sampled trace
    fid = src.meta.env.get("fidelity")
    if isinstance(fid, dict) and fid.get("modes_used") == ["sampled"]:
        interval = int(fid.get("interval", 1))
        if interval > 1:
            t.scale(interval)
    return t


# ---------------------------------------------------------------------------
# Rendering (the §4.3 table)
# ---------------------------------------------------------------------------

_UNITS = ((1_000_000_000, "s"), (1_000_000, "ms"), (1_000, "us"), (1, "ns"))


def fmt_ns(ns: float) -> str:
    for div, unit in _UNITS:
        if abs(ns) >= div:
            return f"{ns / div:.2f}{unit}"
    return f"{ns:.0f}ns"


_BACKEND_LABEL = {
    "ust_repro": "BACKEND_REPRO",
    "ust_jaxrt": "BACKEND_JAXRT",
    "ust_kernel": "BACKEND_KERNEL",
    "ust_collective": "BACKEND_COLL",
    "ust_thapi": "BACKEND_THAPI",
    "ust_user": "BACKEND_USER",
}


def _table(header: Tuple[str, ...], body: List[Tuple[str, ...]]) -> List[str]:
    """Aligned rows: first column left-justified, the rest right-justified."""
    widths = [
        max(len(h), *(len(r[i]) for r in body)) if body else len(h)
        for i, h in enumerate(header)
    ]

    def line(cells):
        return " | ".join(
            c.ljust(w) if i == 0 else c.rjust(w)
            for i, (c, w) in enumerate(zip(cells, widths))
        )

    out = [line(header), "-+-".join("-" * w for w in widths)]
    out.extend(line(r) for r in body)
    return out


def render_by_rank(
    ranks: Dict[str, Tally],
    top: Optional[int] = None,
    device: bool = False,
    label: str = "Rank",
    incarnations: Optional[Dict[str, int]] = None,
    retired: Optional[Sequence[str]] = None,
) -> str:
    """Per-rank summary table (`iprof top --by-rank`, §3.7 + §6).

    One row per source (rank identity): busy time, cluster share, calls,
    mean call latency, and the API that dominates the rank's time — the
    view where stragglers and rank skew are visible.  The merged composite
    (:func:`render`) hides exactly this: a rank 3× slower than its peers
    disappears into the cluster-wide sums.  ``label`` renames the first
    column (``iprof top --by-group`` renders rollup groups with it).

    Elastic annotations (from the master's by-rank metadata): a source with
    ``incarnations[src] > 0`` is a replacement and renders as ``src#N`` so
    it never silently merges with its dead predecessor's identity; a source
    in ``retired`` renders a tombstone marker (``[evicted]``) — its totals
    still count (history is history) but the row is visibly not a live rank.
    """
    incs = incarnations or {}
    dead = set(retired or ())
    per_rank = []
    for src, t in ranks.items():
        table = t.device_apis if device else t.apis
        calls = sum(s.calls for s in table.values())
        total = sum(s.total_ns for s in table.values())
        if table:
            (_, top_api), top_st = max(table.items(), key=lambda kv: kv[1].total_ns)
        else:
            top_api, top_st = "-", None
        per_rank.append((src, calls, total, top_api, top_st))
    per_rank.sort(key=lambda r: -r[2])
    cluster_total = sum(r[2] for r in per_rank) or 1
    if top is not None:
        per_rank = per_rank[:top]

    def name(src: str) -> str:
        inc = int(incs.get(src, 0))
        n = f"{src}#{inc}" if inc else src
        return f"{n} [evicted]" if src in dead else n

    body = [
        (
            name(src),
            fmt_ns(total),
            f"{100.0 * total / cluster_total:.2f}%",
            str(calls),
            fmt_ns(total / calls if calls else 0),
            top_api,
            fmt_ns(top_st.avg_ns) if top_st is not None else "-",
        )
        for src, calls, total, top_api, top_st in per_rank
    ]
    header = (label, "Time", "Time(%)", "Calls", "Average", "Top API", "Top API Avg")
    live = len(ranks) - sum(1 for s in ranks if s in dead)
    summary = f"{len(ranks)} {label.lower()}s"
    if len(ranks) != live:
        summary += f" ({live} live, {len(ranks) - live} evicted)"
    out = [summary]
    out.extend(_table(header, body))
    return "\n".join(out)


def render(t: Tally, top: Optional[int] = None, device: bool = False) -> str:
    table = t.device_apis if device else t.apis
    backends = sorted({_BACKEND_LABEL.get(p, p.upper()) for p, _ in table})
    banner = " | ".join(
        [f"{b}" for b in backends]
        + [
            f"{len(t.hostnames) or 1} Hostnames",
            f"{len(t.processes)} Processes",
            f"{len(t.threads)} Threads",
        ]
    )
    #: host rows of a sampled session are scaled estimates — call counts and
    #: times get a "~" prefix, and the banner says what they are
    est = t.estimated and not device
    total = sum(s.total_ns for s in table.values()) or 1
    rows: List[Tuple] = sorted(table.items(), key=lambda kv: -kv[1].total_ns)
    if top is not None:
        rows = rows[:top]
    header = ("Name", "Time", "Time(%)", "Calls", "Average", "Min", "Max")
    tilde = "~" if est else ""
    body = [
        (
            api,
            tilde + fmt_ns(s.total_ns),
            f"{100.0 * s.total_ns / total:.2f}%",
            tilde + str(s.calls),
            fmt_ns(s.avg_ns),
            fmt_ns(s.min_ns if s.calls else 0),
            fmt_ns(s.max_ns),
        )
        for (prov, api), s in rows
    ]
    out = [banner]
    if est:
        out.append(
            f"[estimated] host rows scaled from 1/{t.sample_interval} "
            "systematic sampling (~ marks unbiased estimates)"
        )
    out.extend(_table(header, body))
    if t.discarded:
        out.append(f"[warning] {t.discarded} events discarded (ring-buffer pressure)")
    return "\n".join(out)
