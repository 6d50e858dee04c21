"""Single-pass trace-fold engine (THAPI §3.4 analysis, made to scale).

The Babeltrace-style graph (``babeltrace.py``) is the *general* analysis
tier: it materializes every record as an :class:`~repro_torch.core.babeltrace.Event`,
globally time-sorts all streams through the muxer, and dict-ifies every
interval — the right shape for pretty-printing, timelines, and validation,
where callbacks need named fields and cross-stream ordering.  For the tally
monoid none of that is necessary:

  * entry/exit pairing is **(pid, tid)-local** (the interval filter keys its
    stacks by ``(pid, tid, provider:api)``), and each CTF-lite stream holds
    exactly one ``(pid, tid)``'s records in timestamp order — so the global
    ``heapq.merge`` time-sort is provably irrelevant to the folded result;
  * a tally reads **at most two payload fields** per record (span begin/end
    timestamps, plus the kernel name for launch spans) — unpacking the full
    payload tuple per event is wasted work;
  * the fold target is a monoid — no intermediate ``Event``/``Interval``
    objects need to exist at all.

This module is that fast tier: an eid-indexed *fold plan* compiled once per
trace model, executed as a tight single-pass loop over framed record buffers
(one ``memoryview`` per chunk, flat ``[calls, total, min, max]`` list
accumulators instead of per-record object churn, kernel-name row keys memoized
on the raw payload bytes).  It is shared by offline analysis
(:func:`fold_trace`, the default behind ``tally_trace``/``iprof tally``) and
by the live analyzer (:class:`repro_torch.core.online.OnlineAnalyzer` folds drained
ring chunks through the same engine), so the two can never diverge.

Equivalence contract: for any trace, ``fold_trace(d)`` and the legacy graph
(``tally_trace(d, legacy_graph=True)``) produce semantically identical
tallies — same rows, same counts/min/max, same process/thread/hostname sets,
same discarded total (property-tested in ``tests/test_fold.py``, including
compressed streams, truncated tails, unmatched entries, and discard
records).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from .api_model import DISCARD_EVENT_ID, FIELD_CLASSES, VARLEN, TraceModel
from .ctf import StreamReader, TraceMeta, load_sidecar, stream_files
from .plugins.tally import ApiStat, Tally, intern_key
from .ringbuffer import RECORD_HEADER, RECORD_HEADER_SIZE

_SPAN_TS = struct.Struct("<QQ")  # ts_begin, ts_end prefix of every span payload
_U64 = struct.Struct("<Q")
_LEN = struct.Struct("<I")  # varlen-field length prefix (see tracepoints codegen)

#: fold-plan opcodes, one per eid (dense dispatch, two list indexes a record)
K_SKIP = 0  # sample / unknown-phase events: nothing a tally reads
K_ENTRY = 1  # push ts on the (pid,tid)-local per-API stack; payload untouched
K_EXIT = 2  # pop + accumulate host row; payload untouched
K_SPAN = 3  # device row from the two leading u64 timestamps
K_SPAN_NAMED = 4  # launch span: row key is the kernel name at a fixed offset
K_DISCARD = 5  # ctf:events_discarded counter
K_SPAN_NAMED_GENERIC = 6  # launch span whose name needs a full payload unpack

#: plan row layout: (kind, key, pair_id, name_off, name_key_cache)
_SKIP_ROW = (K_SKIP, None, -1, 0, None)


def _fixed_offset_of(fields, name: str) -> Optional[int]:
    """Byte offset of a varlen ``str`` field reachable through fixed-size
    predecessors only; None when a varlen field precedes it."""
    off = 0
    for f in fields:
        if f.name == name:
            return off if f.cls == "str" else None
        if f.cls in VARLEN:
            return None
        off += struct.calcsize("<" + FIELD_CLASSES[f.cls])
    return None


class FoldPlan:
    """Per-model dispatch table: what (if anything) each eid contributes.

    Compiled once per :class:`~repro_torch.core.api_model.TraceModel`.  ``rows``
    is a dense eid-indexed list of flat tuples so the fold loop does one
    list index and one tuple unpack per record — no dict lookups, no
    attribute traffic.  Keys are interned ``(provider, api)`` tuples;
    kernel-name keys are memoized per eid on the *raw* name bytes, so a
    launch span's row key costs one small-bytes hash after first sight
    (no utf-8 decode, no tuple allocation).
    """

    __slots__ = ("rows", "pair_keys", "needs_unpack")

    def __init__(self, model: TraceModel):
        self.rows: List[tuple] = [_SKIP_ROW] * len(model.events)
        #: pair_id → interned key, for the unmatched-entry flush
        self.pair_keys: List[Tuple[str, str]] = []
        #: any K_SPAN_NAMED_GENERIC eids? (engine then builds the unpackers)
        self.needs_unpack = False
        pair_of: Dict[Tuple[str, str], int] = {}
        for ev in model.events:
            key = intern_key(ev.provider, ev.api)
            if ev.eid == DISCARD_EVENT_ID and ev.phase == "meta":
                self.rows[ev.eid] = (K_DISCARD, key, -1, 0, None)
            elif ev.phase in ("entry", "exit"):
                pid = pair_of.get(key)
                if pid is None:
                    pid = pair_of[key] = len(self.pair_keys)
                    self.pair_keys.append(key)
                kind = K_ENTRY if ev.phase == "entry" else K_EXIT
                self.rows[ev.eid] = (kind, key, pid, 0, None)
            elif ev.phase == "span":
                # span payloads always open with ts_begin/ts_end (u64 each,
                # SPAN_EXTRA_FIELDS in api_model.build_trace_model)
                if (
                    len(ev.fields) >= 2
                    and ev.fields[0].name == "ts_begin"
                    and ev.fields[1].name == "ts_end"
                ):
                    noff = (
                        _fixed_offset_of(ev.fields[2:], "name")
                        if ev.api == "launch"
                        else None
                    )
                    if noff is not None:
                        # per-eid memo: raw name bytes → interned row key
                        cache: Dict[bytes, Tuple[str, str]] = {}
                        self.rows[ev.eid] = (
                            K_SPAN_NAMED,
                            key,
                            -1,
                            _SPAN_TS.size + noff,
                            cache,
                        )
                    elif ev.api == "launch" and any(
                        f.name == "name" for f in ev.fields[2:]
                    ):
                        # a name field exists but is not reachable at a fixed
                        # offset (varlen predecessor, or non-str class): fall
                        # back to a full payload unpack for this eid only, so
                        # per-kernel rows still match the legacy graph
                        idx = next(
                            i for i, f in enumerate(ev.fields) if f.name == "name"
                        )
                        self.rows[ev.eid] = (K_SPAN_NAMED_GENERIC, key, -1, idx, None)
                        self.needs_unpack = True
                    else:
                        self.rows[ev.eid] = (K_SPAN, key, -1, 0, None)
                # malformed span schema: skip (the legacy graph would fail
                # to unpack it too; lenient skip is the shared behavior)


class FoldState:
    """Mutable fold target: flat row accumulators + (pid, tid)-local stacks.

    Rows are ``[calls, total_ns, min_ns, max_ns]`` lists (cheaper to bump
    than objects); :meth:`to_tally` converts.  One state may be fed chunks
    from many streams/threads (the offline fold walks every stream file of
    a trace; the online analyzer is fed every ring's drains) — pairing
    stays correct because stacks are keyed by ``(pid, tid)`` first, API
    second, exactly like the legacy interval filter.
    """

    __slots__ = (
        "rows",
        "drows",
        "processes",
        "threads",
        "hostnames",
        "stacks",
        "events_seen",
        "discarded",
        "unmatched_exits",
    )

    def __init__(self):
        self.rows: Dict[Tuple[str, str], list] = {}  # host APIs
        self.drows: Dict[Tuple[str, str], list] = {}  # device spans
        self.processes: set = set()
        self.threads: set = set()
        self.hostnames: set = set()
        #: (pid, tid) → {pair_id → [entry timestamps]} (LIFO per API)
        self.stacks: Dict[Tuple[int, int], Dict[int, List[int]]] = {}
        self.events_seen = 0
        self.discarded = 0
        self.unmatched_exits = 0

    def to_tally(self) -> Tally:
        """Materialize the accumulated rows as a fresh Tally (the caller's
        to mutate) — stamped with the discarded total, like the offline
        legacy path."""
        t = Tally()
        t.apis = {
            k: ApiStat(calls=r[0], total_ns=r[1], min_ns=r[2], max_ns=r[3])
            for k, r in self.rows.items()
        }
        t.device_apis = {
            k: ApiStat(calls=r[0], total_ns=r[1], min_ns=r[2], max_ns=r[3])
            for k, r in self.drows.items()
        }
        t.processes |= self.processes
        t.threads |= self.threads
        t.hostnames |= self.hostnames
        t.discarded = self.discarded
        return t


class FoldEngine:
    """Executes a :class:`FoldPlan` over framed record buffers."""

    def __init__(self, model: TraceModel):
        self.model = model
        self.plan = FoldPlan(model)
        if self.plan.needs_unpack:
            # exotic span schema (name behind a varlen field): borrow the
            # generated unpackers for just those eids
            from .tracepoints import Tracepoints

            self._unpack = Tracepoints(model).unpack
        else:
            self._unpack = None

    def new_state(self) -> FoldState:
        return FoldState()

    def fold_chunk(self, state: FoldState, buf, pid: int, tid: int) -> int:
        """Fold one framed-record buffer (a ring drain or a stream region).

        Single pass, no per-record materialization: the record header is the
        batched scan unit, payloads are touched only at the two span
        timestamps (and the launch kernel name).  Returns the number of
        records consumed; a truncated tail (crash mid-write) stops cleanly,
        like ``ctf.StreamReader``.
        """
        if type(buf) is not memoryview:
            buf = memoryview(buf)  # hoisted: one wrap per chunk, not per record
        plan_rows = self.plan.rows
        nplans = len(plan_rows)
        hdr_unpack = RECORD_HEADER.unpack_from
        span_unpack = _SPAN_TS.unpack_from
        len_unpack = _LEN.unpack_from
        u64_unpack = _U64.unpack_from
        tkey = (pid, tid)
        stacks = state.stacks.get(tkey)
        if stacks is None:
            stacks = state.stacks[tkey] = {}
        rows = state.rows
        drows = state.drows
        touched = False
        events = 0
        off = 0
        n = len(buf)
        limit = n - RECORD_HEADER_SIZE
        while off <= limit:
            total, eid, ts = hdr_unpack(buf, off)
            if total < RECORD_HEADER_SIZE or off + total > n:
                break  # truncated tail — stop cleanly
            events += 1
            if eid < nplans:
                kind, key, aid, noff, nkcache = plan_rows[eid]
                if kind == K_ENTRY:
                    stack = stacks.get(aid)
                    if stack is None:
                        stacks[aid] = [ts]
                    else:
                        stack.append(ts)
                elif kind == K_EXIT:
                    stack = stacks.get(aid)
                    if stack:
                        dur = ts - stack.pop()
                        if dur < 0:
                            dur = 0
                        row = rows.get(key)
                        if row is None:
                            rows[key] = [1, dur, dur, dur]
                        else:
                            row[0] += 1
                            row[1] += dur
                            if dur < row[2]:
                                row[2] = dur
                            if dur > row[3]:
                                row[3] = dur
                        touched = True
                    else:
                        state.unmatched_exits += 1
                elif kind >= K_SPAN:
                    rec_end = off + total
                    if kind == K_DISCARD:
                        if off + RECORD_HEADER_SIZE + 8 <= rec_end:
                            state.discarded += u64_unpack(
                                buf, off + RECORD_HEADER_SIZE
                            )[0]
                        off = rec_end
                        continue
                    poff = off + RECORD_HEADER_SIZE
                    if poff + 16 > rec_end:  # short payload: never read past
                        off = rec_end  # the record into its neighbor's bytes
                        continue
                    t0, t1 = span_unpack(buf, poff)
                    dur = t1 - t0
                    if dur < 0:
                        dur = 0
                    if kind == K_SPAN_NAMED:
                        nb_off = poff + noff
                        if nb_off + 4 > rec_end:
                            off = rec_end
                            continue
                        (ln,) = len_unpack(buf, nb_off)
                        if nb_off + 4 + ln > rec_end:  # truncated name field
                            off = rec_end
                            continue
                        nb = bytes(buf[nb_off + 4 : nb_off + 4 + ln])
                        nkey = nkcache.get(nb)
                        if nkey is None:
                            # key is the plan's (provider, api): provider +
                            # decoded kernel name becomes the row key, memoized
                            nkey = nkcache[nb] = intern_key(
                                key[0], nb.decode(errors="replace")
                            )
                        key = nkey
                    elif kind == K_SPAN_NAMED_GENERIC:
                        # noff is the field index of "name" here; the legacy
                        # graph keys launch rows on entry["name"] whatever its
                        # class, so the full unpack keeps parity
                        try:
                            name = self._unpack[eid](buf[poff:rec_end])[noff]
                        except struct.error:
                            off = rec_end
                            continue
                        key = (
                            intern_key(key[0], name)
                            if type(name) is str
                            else (key[0], name)
                        )
                    row = drows.get(key)
                    if row is None:
                        drows[key] = [1, dur, dur, dur]
                    else:
                        row[0] += 1
                        row[1] += dur
                        if dur < row[2]:
                            row[2] = dur
                        if dur > row[3]:
                            row[3] = dur
                    touched = True
                # K_SKIP (samples, unknown phases): header-only cost
            else:
                # eid beyond this model: a record from a newer writer (e.g. a
                # user annotate event this reader's model predates).  Never
                # raise; when the payload opens with a plausible length-
                # prefixed name (the ust_user wire shape), surface it as a
                # name-keyed calls-only passthrough row — otherwise skip on
                # the header alone, the historical behavior.
                poff = off + RECORD_HEADER_SIZE
                rec_end = off + total
                if poff + 4 <= rec_end:
                    (ln,) = len_unpack(buf, poff)
                    if 1 <= ln <= 255 and poff + 4 + ln <= rec_end:
                        name = bytes(buf[poff + 4 : poff + 4 + ln]).decode(
                            errors="replace"
                        )
                        key = intern_key("unknown", name)
                        row = rows.get(key)
                        if row is None:
                            rows[key] = [1, 0, 0, 0]
                        else:
                            row[0] += 1
                        touched = True
            off += total
        state.events_seen += events
        if touched:
            # once per chunk, not per record — sets dedupe, result identical
            state.processes.add(pid)
            state.threads.add(tkey)
        return events

    def finish(self, state: FoldState) -> Tally:
        """Flush unmatched entries (crash mid-call / exits dropped under ring
        pressure) as zero-duration calls — the legacy interval filter's
        behavior, so validation-grade counts survive the fast path — then
        materialize the tally.  Offline-only: the live analyzer never
        flushes (an open call is simply not yet part of the live tally)."""
        rows = state.rows
        pair_keys = self.plan.pair_keys
        for (pid, tid), stacks in state.stacks.items():
            for aid, stack in stacks.items():
                if not stack:
                    continue
                key = pair_keys[aid]
                row = rows.get(key)
                if row is None:
                    rows[key] = [len(stack), 0, 0, 0]
                else:
                    row[0] += len(stack)
                    if row[2] > 0:
                        row[2] = 0
                state.processes.add(pid)
                state.threads.add((pid, tid))
            stacks.clear()
        return state.to_tally()


# ---------------------------------------------------------------------------
# Trace-level fold: sidecar fast path + sharded parallel execution
# ---------------------------------------------------------------------------


def stream_groups(paths: Sequence[str]) -> List[List[str]]:
    """Partition stream paths into ``(pid, tid)``-groups, preserving the
    sorted file order within each group.

    The grouping is the parallel-fold correctness unit: pairing stacks are
    ``(pid, tid)``-local, so streams of *different* groups share no fold
    state and may run in any order on any worker — but two files carrying
    the same ``(pid, tid)`` (multi-rank dirs with rank prefixes) must stay
    together, in order, on one worker, or an entry left open by the first
    file could no longer pair with its exit in the second.
    """
    groups: Dict[Tuple[int, int], List[str]] = {}
    for path in paths:
        reader = StreamReader(path)  # filename parse only, no I/O
        groups.setdefault((reader.pid, reader.tid), []).append(path)
    return list(groups.values())


def _fold_groups(
    trace_dir: str,
    groups: Sequence[Sequence[str]],
    use_sidecar: bool,
    meta: Optional[TraceMeta] = None,
) -> Tally:
    """Fold a set of stream groups into one tally (one worker's share).

    Per group: a trusted columnar sidecar short-circuits record parsing
    entirely (the footer carries the stream's folded tally); otherwise the
    group's records run through the shared engine.  Sidecars are per-stream
    self-contained (their unmatched entries were flushed at write time), so
    the fast path is only taken for single-stream groups — the common case;
    a multi-file ``(pid, tid)`` group needs cross-file stack continuity and
    always folds records.
    """
    if meta is None:
        meta = TraceMeta.load(trace_dir)
    engine = FoldEngine(meta.model)
    state = engine.new_state()
    from_sidecars = Tally()
    for group in groups:
        if use_sidecar and len(group) == 1:
            sc = load_sidecar(group[0])
            if sc is not None:
                from_sidecars.merge(sc.tally())
                continue
        for path in group:
            reader = StreamReader(path)
            buf, release = reader.records_region()
            try:
                engine.fold_chunk(state, buf, reader.pid, reader.tid)
            finally:
                release()
    return engine.finish(state).merge(from_sidecars)


def _fold_shard(trace_dir: str, groups: List[List[str]], use_sidecar: bool) -> dict:
    """Worker entry point: fold one shard, return a compact tally dict.

    Module-level (picklable), loads its own TraceMeta, and mmaps its streams
    via ``records_region`` — worker startup carries no parent state beyond
    the path list.  Exceptions propagate to the parent (which wraps them):
    a poisoned shard must surface, never silently truncate the tally.
    """
    return _fold_groups(trace_dir, groups, use_sidecar).to_obj()


def _partition_groups(groups: List[List[str]], shards: int) -> List[List[List[str]]]:
    """Greedy byte-balanced partition: largest group to the lightest shard."""

    def group_bytes(g: List[str]) -> int:
        return sum(os.path.getsize(p) for p in g)

    sized = sorted(((group_bytes(g), g) for g in groups), key=lambda x: -x[0])
    out: List[List[List[str]]] = [[] for _ in range(shards)]
    loads = [0] * shards
    for size, g in sized:
        i = loads.index(min(loads))
        out[i].append(g)
        loads[i] += size
    return [s for s in out if s]


def fold_trace(trace_dir: str, jobs: int = 1, use_sidecar: bool = True) -> Tally:
    """Fast-path ``tally_trace``: fold a CTF-lite trace directory directly
    into a :class:`~repro_torch.core.plugins.tally.Tally` — no Event/Interval
    materialization, no global time-sort, one mmap'd buffer per stream.

    ``jobs > 1`` shards the per-stream work across a process pool: workers
    fold disjoint ``(pid, tid)`` stream groups through their own engine and
    return compact tally dicts the parent merges.  Because pairing state is
    ``(pid, tid)``-local, the result is identical to ``jobs=1`` for every
    job count (property-tested in ``tests/test_parallel_fold.py``).
    ``jobs=None`` means one worker per CPU.  A failing worker (corrupt
    stream, killed process) raises ``RuntimeError`` naming the cause — a
    partial tally is never returned.

    ``use_sidecar=False`` disables the columnar fast path (``.ctfcol``
    footers); the default trusts validated sidecars and skips record
    parsing for those streams.
    """
    meta = TraceMeta.load(trace_dir)
    groups = stream_groups(stream_files(trace_dir))
    if jobs is None:
        jobs = os.cpu_count() or 1
    jobs = max(1, min(int(jobs), len(groups) or 1))
    if jobs <= 1:
        tally = _fold_groups(trace_dir, groups, use_sidecar, meta=meta)
    else:
        from concurrent.futures import ProcessPoolExecutor

        shards = _partition_groups(groups, jobs)
        tally = Tally()
        try:
            with ProcessPoolExecutor(max_workers=len(shards)) as ex:
                futures = [
                    ex.submit(_fold_shard, trace_dir, shard, use_sidecar)
                    for shard in shards
                ]
                for f in futures:
                    tally.merge(Tally.from_obj(f.result()))
        except Exception as e:
            raise RuntimeError(
                f"parallel fold (jobs={jobs}) failed; no partial tally: {e}"
            ) from e
    host = meta.env.get("hostname", "")
    if host:
        tally.hostnames.add(host)
    # sampled-session estimator: a trace recorded *entirely* on the
    # "sampled" fidelity rung carries exact 1/N semantics — scale the host
    # rows into unbiased estimates.  Mixed-fidelity sessions (mid-run rung
    # flips) keep their raw conservative counts: a uniform scale would be
    # wrong for the windows recorded at other rungs, and the advisory
    # records in the trace mark exactly when the rungs changed.
    fid = meta.env.get("fidelity")
    if isinstance(fid, dict) and fid.get("modes_used") == ["sampled"]:
        interval = int(fid.get("interval", 1))
        if interval > 1:
            tally.scale(interval)
    return tally
