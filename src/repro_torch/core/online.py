"""Online trace analysis (THAPI §6 future work, implemented).

    "we are also working on online trace analysis, where tracing and analysis
     can be performed concurrently to enable adaptive optimizations during
     application runtime."

The consumer daemon can hand each drained chunk to an :class:`OnlineAnalyzer`
that decodes records incrementally and maintains a LIVE tally (same monoid as
the offline plugin), without waiting for session stop.  The trainer (or an
adaptive policy) can read ``snapshot()`` mid-run — e.g. to detect a dispatch/
poll imbalance and adjust microbatching, the paper's "adaptive optimization"
loop.

Implementation: the analyzer folds the same framed record stream the CTF
writer receives through the shared single-pass fold engine
(:mod:`repro_torch.core.fold`) — the exact code path behind the offline
``tally_trace`` fast path, so live snapshots and offline tallies can never
diverge.  The write path stays zero-cost; analysis rides the consumer
thread.  Pairing stacks are keyed ``(pid, tid)`` first, so multi-process
chunk feeds (a master analyzing several ranks' drains) can never cross-match
an entry from one process with an exit from another.
"""

from __future__ import annotations

import threading

from .api_model import TraceModel
from .fold import FoldEngine
from .plugins.tally import Tally


class OnlineAnalyzer:
    """Incremental entry/exit folding + live tally over drained chunks.

    The live member of the analysis family: fed by the tracer's consumer
    thread (never by recorders), it folds the framed record stream into the
    same :class:`~repro_torch.core.plugins.tally.Tally` monoid the offline plugin
    produces, so live snapshots, streamed snapshots, and batch aggregates
    all merge interchangeably.  ``snapshot()`` is what the streaming layer
    ships and the adaptive controller diffs.
    """

    def __init__(self, model: TraceModel, hostname: str = ""):
        self.model = model
        self._engine = FoldEngine(model)
        self._lock = threading.Lock()
        self._state = self._engine.new_state()
        if hostname:
            self._state.hostnames.add(hostname)

    @property
    def events_seen(self) -> int:
        """Records folded so far (all phases, including skipped samples)."""
        return self._state.events_seen

    @property
    def discarded(self) -> int:
        """Cumulative ctf:events_discarded count observed in the feed."""
        return self._state.discarded

    def feed(self, chunk, pid: int = 0, tid: int = 0) -> None:
        """Fold one drained ring-buffer chunk into the live tally.

        ``chunk`` is any bytes-like object; the tracer's zero-copy drain
        passes a ``memoryview`` over ring storage directly (the fold is
        synchronous, so the region may be released when this returns).
        Entry events open per-``(pid, tid)``, per-API LIFO stacks; exits pop
        and accumulate; device spans accumulate directly; discard records
        bump ``discarded``.  One shared fold pass, one memoryview per chunk.
        Safe to call concurrently with ``snapshot()``.
        """
        with self._lock:
            self._engine.fold_chunk(self._state, chunk, pid, tid)

    def note_discarded(self, n: int) -> None:
        """Account ring drops observed by the consumer directly (tally-only
        fidelity: there is no stream file to carry a discard record)."""
        if n > 0:
            with self._lock:
                self._state.discarded += n

    def finish(self, scale: int = 1) -> Tally:
        """Final tally at session stop: flush unmatched entries as
        zero-duration calls (exactly :meth:`FoldEngine.finish`, so a
        tally-only session's aggregate matches what the offline fold of the
        same records would produce) and, when ``scale > 1``, apply the
        1/N sampling estimator (calls and total durations scale by N; the
        tally is marked estimated).  Terminal: the state has been mutated by
        the flush, so ``feed`` must not be called afterwards."""
        with self._lock:
            t = self._engine.finish(self._state)
        if scale > 1:
            t.scale(scale)
        return t

    def snapshot(self) -> Tally:
        """Copy-on-read live tally (safe to render while tracing continues).

        Open (not yet exited) calls are not part of the snapshot — they join
        the tally when their exit record arrives, matching the cumulative
        semantics the streaming deltas rely on.  The discarded counter is
        stamped in, so streamed snapshots carry ring-pressure evidence."""
        with self._lock:
            return self._state.to_tally()

    def busy_fraction(self, provider: str, api: str, window_total_ns: int) -> float:
        """Adaptive-optimization helper: share of wall time inside an API.

        Cumulative since session start — the caller supplies the elapsed
        window (``window_total_ns``).  For *recent* busy fractions computed
        from successive snapshots, diff two :meth:`snapshot` results.
        """
        with self._lock:
            row = self._state.rows.get((provider, api))
            return (row[1] / window_total_ns) if row and window_total_ns else 0.0
