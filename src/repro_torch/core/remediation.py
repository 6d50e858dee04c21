"""Closed-loop remediation: act on cluster flags instead of paging a human.

On its own, ``StragglerRankPolicy`` only flags a lagging rank into the
trainer's ``StragglerWatchdog`` and a human (or nothing) takes it from
there.  This module closes the loop:
:class:`RemediationEngine` consumes those flags — straggler, imbalance,
sick-host — and walks a configurable **escalation ladder**:

    rung 0  ``escalate_fidelity``   turn up tracing on the suspect rank
                                    (``repro_torch.trace.set_mode``, the
                                    fidelity ladder)
                                    so the diagnosis sharpens before anything
                                    destructive happens;
    rung 1  ``checkpoint_drain``    checkpoint the trainer and quiesce the
                                    suspect (async ``Checkpointer.save`` +
                                    drain hooks in ``train/trainer.py``);
    rung 2  ``replace``             spawn a fresh incarnation of the drained
                                    rank, restore it from the drain
                                    checkpoint, and splice it back into the
                                    mesh (``launch/elastic.py``) — the rung
                                    exists only when a ``replace`` hook is
                                    configured; without one the ladder goes
                                    straight from drain to evict, exactly
                                    the pre-elastic behavior;
    rung 3  ``evict``               drop the sustained-bad rank from the
                                    active set and re-mesh onto survivors
                                    (``launch/mesh.py``) — the fallback when
                                    replacement is off, over budget, or
                                    failed ``replace_retries`` times.

Control-theory guardrails, all tunable:

* **cooldown** — a rung will not re-fire for the same target within
  ``cooldown_s`` of its last firing;
* **capped-exponential backoff** — a rung whose hook *failed* retries at
  ``cooldown_s * 2^attempts`` capped at ``backoff_cap_s``;
* **escalation patience** — ``escalate_after`` consecutive flagged
  evaluations (while a rung is already active) before the next rung fires;
* **hysteresis** — ``healthy_windows`` consecutive healthy observations
  de-escalate one rung at a time (never straight to zero), and a target is
  only forgotten once it walks all the way back down;
* **dry_run** — decisions are logged and traced but no hook is invoked:
  the advisory-only mode for gaining confidence in a new policy.

Invariants (asserted by the chaos tests):

* **drain-before-evict** — the ladder is strictly ordered; ``evict`` can
  only fire after ``checkpoint_drain`` *succeeded* for that target.
* **remediation is observable** — every decision (including dry-run and
  failed-hook decisions) is recorded as a ``ust_repro:remediation`` trace
  event, so the remediation itself shows up in the tally like any API.

The engine is transport-agnostic and clock-injectable: feed it flags from a
``ClusterAdaptiveController`` (``on_flag=engine.ingest_flag``), from a test,
or from a driver loop, and drive :meth:`tick` from any cadence you like.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "RemediationAction",
    "RemediationHooks",
    "RemediationEngine",
    "RUNG_ESCALATE",
    "RUNG_DRAIN",
    "RUNG_REPLACE",
    "RUNG_EVICT",
]

RUNG_ESCALATE = "escalate_fidelity"
RUNG_DRAIN = "checkpoint_drain"
RUNG_REPLACE = "replace"
RUNG_EVICT = "evict"
_DEESCALATE = "deescalate"
_RECOVER = "recover"

Hook = Callable[[str, str], bool]


@dataclass(frozen=True)
class RemediationAction:
    """One ladder decision, for the audit log (and the trace)."""

    ts: float
    action: str       # rung name, "deescalate", or "recover"
    target: str       # rank source id ("host:pid:rankN")
    detail: str       # reason / evidence summary
    rung: int         # ladder index the target is at after this action
    ok: bool          # hook outcome (True in dry_run / no-hook cases)
    dry_run: bool

    def __str__(self) -> str:
        mode = " [dry-run]" if self.dry_run else ("" if self.ok else " [FAILED]")
        return f"[{self.ts:.3f}] {self.action}({self.target}): {self.detail}{mode}"


@dataclass
class RemediationHooks:
    """The engine's effectors; each takes ``(target, reason) -> bool``.

    ``escalate``   rung 0 — raise trace fidelity on the target rank.
    ``drain``      rung 1 — checkpoint the trainer and quiesce the target.
    ``replace``    rung 2 — spawn/restore/splice a fresh incarnation of the
                   drained rank (``launch/elastic.py``).
    ``evict``      rung 3 — remove the target from the active set, re-mesh.
    ``restore``    called on full recovery (hysteresis walked the target
                   back to healthy) — e.g. undo the fidelity escalation.

    A missing hook makes its rung advisory-only (the decision is still
    logged and traced, and counts as succeeded so the ladder can progress);
    a hook returning ``False`` or raising marks the attempt failed and the
    rung retries with capped-exponential backoff.  ``replace`` is the one
    exception to advisory-only: when it is ``None`` the rung is *skipped*
    entirely (drain escalates straight to evict) — treating a no-op as a
    successful replacement would reset the ladder and the sick rank would
    never be dealt with.
    """

    escalate: Optional[Hook] = None
    drain: Optional[Hook] = None
    replace: Optional[Hook] = None
    evict: Optional[Hook] = None
    restore: Optional[Hook] = None

    def for_rung(self, name: str) -> Optional[Hook]:
        return {
            RUNG_ESCALATE: self.escalate,
            RUNG_DRAIN: self.drain,
            RUNG_REPLACE: self.replace,
            RUNG_EVICT: self.evict,
        }[name]


@dataclass
class _TargetState:
    """Per-target ladder position and timers."""

    rung: int = -1               # -1 = healthy, 0.. = highest rung fired
    flagged: bool = False        # flag seen since last tick
    last_kind: str = ""
    last_detail: str = ""
    flag_streak: int = 0         # consecutive flagged evaluations
    healthy_streak: int = 0      # consecutive healthy evaluations
    last_fire: float = -1e18     # when any rung last fired for this target
    attempts: int = 0            # failed attempts at ``retry_rung``
    retry_rung: int = 0          # rung to retry after a failed hook
    drained: bool = False        # checkpoint_drain succeeded
    evicted: bool = False

    def next_delay(self, cooldown_s: float, cap_s: float) -> float:
        """Seconds after ``last_fire`` before this target may act again."""
        return min(cooldown_s * (2.0 ** self.attempts), cap_s)


class RemediationEngine:
    """Walks flagged targets up the escalation ladder, healthy ones down.

    Thread-safe: flags typically arrive from the cluster controller's tick
    (consumer thread) while :meth:`tick` may run on a driver loop.
    """

    RUNGS: Tuple[str, ...] = (RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE, RUNG_EVICT)

    def __init__(
        self,
        hooks: Optional[RemediationHooks] = None,
        *,
        cooldown_s: float = 5.0,
        backoff_cap_s: float = 60.0,
        escalate_after: int = 2,
        healthy_windows: int = 3,
        dry_run: bool = False,
        max_evictions: int = 1,
        max_replacements: int = 1,
        replace_retries: int = 2,
        clock: Callable[[], float] = time.monotonic,
        on_action: Optional[Callable[[RemediationAction], None]] = None,
    ):
        if cooldown_s <= 0:
            raise ValueError("cooldown_s must be > 0")
        if backoff_cap_s < cooldown_s:
            raise ValueError("backoff_cap_s must be >= cooldown_s")
        if escalate_after < 1 or healthy_windows < 1:
            raise ValueError("escalate_after and healthy_windows must be >= 1")
        if max_replacements < 0 or replace_retries < 0:
            raise ValueError("max_replacements and replace_retries must be >= 0")
        self.hooks = hooks or RemediationHooks()
        self.cooldown_s = cooldown_s
        self.backoff_cap_s = backoff_cap_s
        self.escalate_after = escalate_after
        self.healthy_windows = healthy_windows
        self.dry_run = dry_run
        self.max_evictions = max_evictions
        self.max_replacements = max_replacements
        self.replace_retries = replace_retries
        self.replacements = 0  # successful (non-dry-run) replace rungs fired
        self.actions: List[RemediationAction] = []
        self.clock = clock
        self.on_action = on_action
        self.targets: Dict[str, _TargetState] = {}
        self._trace_record = None  # ust_repro:remediation recorder, when traced
        # re-entrant: a replace hook runs under the lock and its spawn/admit
        # sub-events come back in through note() on the same thread
        self._lock = threading.RLock()

    # -- wiring ------------------------------------------------------------

    def attach(self, tracer) -> "RemediationEngine":
        """Bind to a live tracing session: decisions land in its trace."""
        rec = getattr(tracer, "tp", None)
        self._trace_record = rec.record.get("ust_repro:remediation") if rec else None
        return self

    # -- evidence in -------------------------------------------------------

    def ingest_flag(self, source: str, kind: str = "straggler", detail: str = "") -> None:
        """Report ``source`` as unhealthy (controller ``on_flag`` callback)."""
        with self._lock:
            st = self.targets.setdefault(source, _TargetState())
            if st.evicted:
                return
            st.flagged = True
            st.last_kind = kind
            st.last_detail = detail

    def observe_healthy(self, source: str) -> None:
        """Report ``source`` healthy this window (drives hysteresis)."""
        with self._lock:
            st = self.targets.get(source)
            if st is None or st.evicted:
                return
            st.flagged = False

    # -- decisions out -----------------------------------------------------

    def _emit(self, action: str, target: str, detail: str, rung: int, ok: bool) -> RemediationAction:
        act = RemediationAction(self.clock(), action, target, detail, rung, ok, self.dry_run)
        self.actions.append(act)
        if self._trace_record is not None:
            try:
                tag = detail if not self.dry_run else f"dry_run {detail}"
                if not ok:
                    tag = f"FAILED {tag}"
                self._trace_record(action, target, tag)
            except Exception:
                pass  # observability must never break remediation
        if self.on_action is not None:
            self.on_action(act)
        return act

    def _invoke(self, rung_name: str, target: str, reason: str) -> bool:
        if self.dry_run:
            return True
        hook = self.hooks.for_rung(rung_name)
        if hook is None:
            return True  # advisory-only rung: decision stands, ladder moves on
        try:
            return bool(hook(target, reason))
        except Exception:
            return False

    def tick(self, now: Optional[float] = None) -> List[RemediationAction]:
        """Evaluate every target once; returns the actions fired this tick."""
        if now is None:
            now = self.clock()
        fired: List[RemediationAction] = []
        with self._lock:
            for target, st in self.targets.items():
                if st.evicted:
                    continue
                if st.flagged:
                    st.flag_streak += 1
                    st.healthy_streak = 0
                    act = self._consider_escalation(target, st, now)
                    if act is not None:
                        fired.append(act)
                    st.flagged = False  # consume; next window must re-flag
                else:
                    st.flag_streak = 0
                    st.healthy_streak += 1
                    act = self._consider_deescalation(target, st, now)
                    if act is not None:
                        fired.append(act)
        return fired

    def _replace_available(self) -> bool:
        """Whether the replace rung can fire at all right now."""
        if self.hooks.replace is None and not self.dry_run:
            return False  # no effector: skip the rung, don't fake success
        return self.replacements < self.max_replacements

    def _consider_escalation(self, target: str, st: _TargetState, now: float) -> Optional[RemediationAction]:
        if now - st.last_fire < st.next_delay(self.cooldown_s, self.backoff_cap_s):
            return None  # cooling down (or backing off after a failure)
        if st.attempts > 0:
            next_rung = st.retry_rung  # retry the failed rung before moving on
            if (
                self.RUNGS[next_rung] == RUNG_REPLACE
                and st.attempts > self.replace_retries
            ):
                next_rung += 1  # capped retries exhausted: fall through to evict
        elif st.rung < 0:
            next_rung = 0  # first evidence acts immediately: cheap rung only
        elif st.flag_streak >= self.escalate_after:
            next_rung = st.rung + 1
        else:
            return None  # flagged but not sustained: hold the current rung
        if (
            next_rung < len(self.RUNGS)
            and self.RUNGS[next_rung] == RUNG_REPLACE
            and not self._replace_available()
        ):
            next_rung += 1  # replacement off / over budget: straight to evict
        if next_rung >= len(self.RUNGS):
            return None  # already at the top; nothing above evict
        name = self.RUNGS[next_rung]
        if name == RUNG_REPLACE:
            # replace shares evict's precondition: only a drained target may
            # be torn down and re-spawned (its drain checkpoint is the
            # restore point the replacement comes back from).
            if not st.drained and not self.dry_run:
                return None
        if name == RUNG_EVICT:
            # drain-before-evict invariant, and an eviction budget so a
            # miscalibrated policy cannot shrink the cluster to nothing.
            if not st.drained and not self.dry_run:
                return None
            evicted = sum(1 for s in self.targets.values() if s.evicted)
            if evicted >= self.max_evictions:
                return None
        reason = f"{st.last_kind}: {st.last_detail}" if st.last_detail else st.last_kind
        ok = self._invoke(name, target, reason)
        st.last_fire = now
        if ok:
            st.rung = next_rung
            st.attempts = 0
            st.flag_streak = 0
            if name == RUNG_DRAIN:
                st.drained = True
            if name == RUNG_EVICT and not self.dry_run:
                st.evicted = True
            if name == RUNG_REPLACE and not self.dry_run:
                # The target is now a *new process*: its ladder history
                # belongs to the dead incarnation, so start it fresh (only
                # the replacement budget carries over).
                self.replacements += 1
                st.rung = -1
                st.drained = False
                st.flag_streak = 0
                st.healthy_streak = 0
        else:
            st.retry_rung = next_rung
            st.attempts += 1
        return self._emit(name, target, reason, st.rung, ok)

    def _consider_deescalation(self, target: str, st: _TargetState, now: float) -> Optional[RemediationAction]:
        if st.rung < 0 or st.healthy_streak < self.healthy_windows:
            return None
        st.healthy_streak = 0
        st.attempts = 0
        st.rung -= 1  # one rung at a time: hysteresis, not amnesia
        if st.rung < 0:
            st.drained = False
            ok = True
            if not self.dry_run and self.hooks.restore is not None:
                try:
                    ok = bool(self.hooks.restore(target, "recovered"))
                except Exception:
                    ok = False
            return self._emit(_RECOVER, target, f"healthy x{self.healthy_windows}", st.rung, ok)
        return self._emit(_DEESCALATE, target, f"healthy x{self.healthy_windows}", st.rung, True)

    def note(self, action: str, target: str, detail: str = "", ok: bool = True) -> RemediationAction:
        """Record an out-of-band remediation event in the audit log/trace.

        The elastic layer uses this for sub-decisions the ladder itself does
        not drive — replacement spawn attempts, mesh splices, fence rejects —
        so the full spawn/admit/fence story reads out of one audit trail.
        """
        with self._lock:
            st = self.targets.get(target)
            return self._emit(action, target, detail, st.rung if st else -1, ok)

    # -- introspection -----------------------------------------------------

    @property
    def evicted(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(t for t, s in self.targets.items() if s.evicted)

    def rung_of(self, source: str) -> int:
        """Current ladder rung for ``source`` (-1 = healthy/unknown)."""
        with self._lock:
            st = self.targets.get(source)
            return st.rung if st is not None else -1

    def render_log(self) -> str:
        """Human-readable decision log (one line per action)."""
        return "\n".join(str(a) for a in self.actions)
