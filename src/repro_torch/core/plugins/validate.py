"""Post-mortem validation plugin (THAPI §4.2).

The paper built a validation plugin to catch low-level API misuse that leads
to undefined behavior (uninitialized pNext, unhandled release events,
non-reset command lists).  Our stack's equivalents:

  unmatched_entry     API entered, never exited (crash / dropped exit)
  unmatched_exit      exit without entry (dropped entry under pressure)
  unreleased_alloc    ust_torchrt:alloc without matching free (≙ unreleased events)
  zero_copy           memcpy with nbytes == 0 (≙ degenerate command)
  self_copy           memcpy src == dst
  nan_loss            train/eval step whose loss OutScalar is NaN (UB analogue)
  nonfinite_gradnorm  gradient norm inf/NaN — diverged step
  time_regression     device span with end < begin
  discarded_events    ring-buffer drops present → coverage warning
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from ..babeltrace import CTFSource, IntervalFilter
from ..metababel import Dispatcher


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str  # "error" | "warning"
    rule: str
    message: str
    ts: int = 0


def validate_trace(trace_dir: str) -> List[Finding]:
    findings: List[Finding] = []
    src = CTFSource(trace_dir)

    allocs: Dict[int, int] = {}  # ptr → ts
    freed_unknown = 0

    # Metababel-style callback plugin over raw events for the alloc/free and
    # scalar checks; intervals pass below for matching/duration checks.
    d = Dispatcher(src.model)

    def on_alloc_exit(ev):
        allocs[ev.field("ptr")] = ev.ts

    def on_free_entry(ev):
        nonlocal freed_unknown
        if allocs.pop(ev.field("ptr"), None) is None:
            freed_unknown += 1

    def on_memcpy_entry(ev):
        f = ev.asdict()
        if f["nbytes"] == 0:
            findings.append(Finding("warning", "zero_copy", "memcpy with nbytes == 0", ev.ts))
        if f["src"] == f["dst"]:
            findings.append(Finding("warning", "self_copy", "memcpy src == dst", ev.ts))

    def check_loss(ev):
        f = ev.asdict()
        loss = f.get("loss")
        if loss is not None and not math.isfinite(loss):
            findings.append(
                Finding("error", "nan_loss", f"non-finite loss {loss} in {ev.etype.api}", ev.ts)
            )
        gn = f.get("grad_norm")
        if gn is not None and not math.isfinite(gn):
            findings.append(
                Finding("error", "nonfinite_gradnorm", f"non-finite grad_norm {gn}", ev.ts)
            )

    d.on("ust_torchrt:alloc_exit", on_alloc_exit)
    d.on("ust_torchrt:free_entry", on_free_entry)
    d.on("ust_torchrt:memcpy_entry", on_memcpy_entry)
    d.on("ust_repro:train_step_exit", check_loss)
    d.on("ust_repro:eval_step_exit", check_loss)
    d.run(iter(src))

    for ptr, ts in allocs.items():
        findings.append(
            Finding("warning", "unreleased_alloc", f"alloc 0x{ptr:012x} never freed", ts)
        )
    if freed_unknown:
        findings.append(
            Finding("warning", "unknown_free", f"{freed_unknown} frees of untracked pointers")
        )

    # second pass: interval matching + durations (needs a fresh source)
    src2 = CTFSource(trace_dir)
    filt = IntervalFilter(iter(src2))
    for iv in filt:
        if iv.exit is None and not iv.device:
            findings.append(
                Finding(
                    "warning",
                    "unmatched_entry",
                    f"{iv.provider}:{iv.api} entered at {iv.ts} but never exited",
                    iv.ts,
                )
            )
        if iv.device and iv.dur == 0:
            findings.append(
                Finding("warning", "time_regression", f"device span {iv.api} has end <= begin", iv.ts)
            )
    if filt.unmatched_exits:
        findings.append(
            Finding("warning", "unmatched_exit", f"{filt.unmatched_exits} exits without entries")
        )
    if src2.discarded or src.discarded:
        findings.append(
            Finding(
                "warning",
                "discarded_events",
                f"{max(src.discarded, src2.discarded)} events discarded — coverage incomplete",
            )
        )
    return findings


def render(findings: List[Finding]) -> str:
    if not findings:
        return "validation: clean (0 findings)"
    lines = [f"validation: {len(findings)} finding(s)"]
    for f in findings:
        lines.append(f"  [{f.severity}] {f.rule}: {f.message}")
    return "\n".join(lines)
