"""repro_torch.trace — the public in-process user API (≙ Extrae's user API).

Application code talks to the active tracing session through this module:

    import repro_torch.trace as trace

    trace.annotate("epoch_boundary", epoch=3, lr=1e-4)   # one-shot marker
    with trace.phase("warmup"):                          # bracketed phase
        ...
    trace.set_mode("sampled")                            # fidelity ladder

``annotate`` and ``phase`` emit first-class ``ust_user`` records through the
exact ring/stream/fold path traced APIs use — they appear in streams, the
timeline, and (phases) the tally like any other event.  Every call is a
no-op when no session is active (or the rank is unselected), so library code
can annotate unconditionally.

``set_mode`` moves the session along the fidelity ladder —
``"full" | "sampled" | "tally-only" | "off"`` — mid-run with a torn-free
handoff (see :meth:`repro_torch.core.tracer.Tracer.set_mode`).  This is the
escalate-on-trouble lever: run cheap (``tally-only`` or ``sampled``) by
default, flip to ``full`` when something looks wrong, flip back after.
"""

from __future__ import annotations

import contextlib
import json
from typing import Iterator, Optional

from .core.clock import now as _now
from .core.tracepoints import FIDELITY_MODES
from .core.tracer import active_tracer

__all__ = ["FIDELITY_MODES", "annotate", "phase", "set_mode", "get_mode"]


def annotate(name: str, **payload) -> bool:
    """Emit a ``ust_user:annotate`` marker into the active trace.

    ``payload`` keyword arguments are JSON-encoded (sorted keys; non-JSON
    values fall back to ``str``) into the record, so arbitrary context rides
    into the timeline/pretty views.  Returns True when a record was offered
    to the session's ring path, False when there was no active session (or
    tracing is off for this rank) — callers never need to guard.
    """
    tr = active_tracer()
    if tr is None or not tr.selected:
        return False
    rec = tr.tp.record.get("ust_user:annotate")
    if rec is None:  # custom model without the user events
        return False
    rec(name, json.dumps(payload, sort_keys=True, default=str) if payload else "")
    return True


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Bracket an application phase as a ``ust_user:phase`` entry/exit pair.

    Folds and tallies exactly like a traced API call (one host row keyed
    ``ust_user:phase``), nests, and is sampled on the "sampled" fidelity
    rung like every other entry/exit pair.  No-op without an active session.
    """
    tr = active_tracer()
    rec = None
    if tr is not None and tr.selected:
        rec = tr.tp.record_pair.get("ust_user:phase")
    if rec is None:
        yield
        return
    ts = _now()
    try:
        yield
    finally:
        # fused pair recorder: (entry name, _ts_entry, exit name)
        rec(name, ts, name)


def set_mode(mode: str) -> str:
    """Move the active session to another fidelity rung; returns the
    previous rung.  Raises ``RuntimeError`` when no session is active and
    ``ValueError`` for an unknown mode."""
    if mode not in FIDELITY_MODES:
        raise ValueError(f"unknown fidelity {mode!r} (want one of {FIDELITY_MODES})")
    tr = active_tracer()
    if tr is None:
        raise RuntimeError("no active tracing session")
    return tr.set_mode(mode)


def get_mode() -> Optional[str]:
    """Current fidelity rung of the active session, or None without one."""
    tr = active_tracer()
    return tr.fidelity if tr is not None else None
