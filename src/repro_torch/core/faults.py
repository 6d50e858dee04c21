"""Deterministic fault injection for chaos testing the tracing control loop.

The closed-loop remediation stack (``core/remediation.py``) claims it can
flag, drain, and evict a sick rank.  That claim is only testable if we can
*make* a rank sick on demand, reproducibly.  :class:`FaultInjector` is that
harness: a seeded, purely-deterministic schedule of faults a worker consults
at step boundaries (slowdowns, hangs, kills) and that the stream layer can
consult per frame (connection drops, corrupt/truncated frames).

Design rules:

* **Deterministic.**  Same ``FaultSpec`` + same seed → same schedule, on
  every platform.  Randomness comes only from a private ``random.Random``;
  nothing reads the wall clock.
* **Pull, not push.**  The injector never spawns threads or patches code;
  the instrumented site *asks* (``sleep_s(step)``, ``should_die(step)``,
  ``mangle_frame(payload)``) and acts on the answer.  Un-asked faults are
  inert, so wiring the injector into production code paths is safe.
* **CLI-parseable.**  ``FaultSpec.parse("slowdown:rank=1,after=10,factor=8")``
  gives the example driver and CI a one-string interface
  (``--inject-fault=...``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["FaultKind", "FaultSpec", "FaultInjector", "parse_fault_specs"]


class FaultKind:
    """Enumeration of injectable fault classes (plain strings on the wire)."""

    SLOWDOWN = "slowdown"  # rank sleeps extra seconds per step
    HANG = "hang"          # rank stops making progress (driver must act)
    KILL = "kill"          # rank process exits hard mid-run
    DROP = "drop"          # stream connection dropped before a frame
    CORRUPT = "corrupt"    # frame payload bytes flipped
    TRUNCATE = "truncate"  # frame payload cut short

    ALL = (SLOWDOWN, HANG, KILL, DROP, CORRUPT, TRUNCATE)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``kind``      one of :class:`FaultKind`.
    ``rank``      target rank (-1 = every rank).
    ``after``     first step (or frame ordinal, for stream faults) affected.
    ``factor``    slowdown multiplier (slowdown) — extra sleep is
                  ``base_step_s * (factor - 1)`` per step.
    ``p``         per-step/per-frame probability in [0, 1]; 1.0 = always
                  (once past ``after``).  Drawn from the injector's seeded
                  stream, so schedules stay reproducible.
    ``duration``  how many steps the fault stays active (0 = forever).
    """

    kind: str
    rank: int = -1
    after: int = 0
    factor: float = 4.0
    p: float = 1.0
    duration: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FaultKind.ALL:
            raise ValueError(f"unknown fault kind {self.kind!r} (know {FaultKind.ALL})")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault probability must be in [0,1], got {self.p}")
        if self.factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {self.factor}")
        if self.after < 0 or self.duration < 0:
            raise ValueError("after/duration must be >= 0")

    def active_at(self, step: int) -> bool:
        if step < self.after:
            return False
        if self.duration and step >= self.after + self.duration:
            return False
        return True

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse ``kind[:k=v,k=v,...]`` — e.g. ``slowdown:rank=1,after=10,factor=8``."""
        text = text.strip()
        if not text:
            raise ValueError("empty fault spec")
        kind, _, rest = text.partition(":")
        kw: Dict[str, object] = {}
        if rest:
            for item in rest.split(","):
                if not item.strip():
                    continue
                key, eq, val = item.partition("=")
                key = key.strip()
                if not eq:
                    raise ValueError(f"bad fault option {item!r} (want k=v)")
                if key in ("rank", "after", "duration"):
                    kw[key] = int(val)
                elif key in ("factor", "p"):
                    kw[key] = float(val)
                else:
                    raise ValueError(f"unknown fault option {key!r}")
        return cls(kind=kind.strip(), **kw)  # type: ignore[arg-type]

    def render(self) -> str:
        return (
            f"{self.kind}:rank={self.rank},after={self.after},"
            f"factor={self.factor:g},p={self.p:g},duration={self.duration}"
        )


def parse_fault_specs(text: str) -> Tuple[FaultSpec, ...]:
    """Parse a ``;``-separated list of fault specs (CLI ``--inject-fault``)."""
    specs = tuple(FaultSpec.parse(part) for part in text.split(";") if part.strip())
    if not specs:
        raise ValueError(f"no fault specs in {text!r}")
    return specs


@dataclass
class FaultInjector:
    """Seeded schedule of faults one process consults.

    ``rank`` scopes the injector: specs targeting another rank are ignored,
    so every worker can be handed the same spec string and the same seed and
    still produce a globally consistent (and reproducible) schedule.
    """

    specs: Tuple[FaultSpec, ...] = ()
    rank: int = 0
    seed: int = 0
    log: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        # One private stream per (seed, rank): deterministic per-process,
        # uncorrelated across ranks.
        self._rng = random.Random((self.seed << 16) ^ (self.rank & 0xFFFF))

    # -- selection ---------------------------------------------------------

    def _mine(self, kind: str, step: int) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.kind != kind:
                continue
            if spec.rank not in (-1, self.rank):
                continue
            if not spec.active_at(step):
                continue
            if spec.p >= 1.0 or self._rng.random() < spec.p:
                return spec
        return None

    def _note(self, what: str) -> None:
        self.log.append(what)

    # -- step-boundary faults (worker loop asks each step) -----------------

    def sleep_s(self, step: int, base_step_s: float = 0.01) -> float:
        """Extra seconds this rank should sleep at ``step`` (0.0 = healthy)."""
        spec = self._mine(FaultKind.SLOWDOWN, step)
        if spec is None:
            return 0.0
        extra = base_step_s * max(spec.factor - 1.0, 0.0)
        self._note(f"slowdown step={step} extra={extra:.4f}s")
        return extra

    def should_hang(self, step: int) -> bool:
        """True if this rank must stop progressing at ``step``."""
        spec = self._mine(FaultKind.HANG, step)
        if spec is not None:
            self._note(f"hang step={step}")
            return True
        return False

    def should_die(self, step: int) -> bool:
        """True if this rank must hard-exit at ``step`` (caller does os._exit)."""
        spec = self._mine(FaultKind.KILL, step)
        if spec is not None:
            self._note(f"kill step={step}")
            return True
        return False

    # -- stream-layer faults (per outgoing frame) --------------------------

    def should_drop_connection(self, frame_no: int) -> bool:
        """True if the streamer should sever its connection before this frame."""
        spec = self._mine(FaultKind.DROP, frame_no)
        if spec is not None:
            self._note(f"drop frame={frame_no}")
            return True
        return False

    def mangle_frame(self, payload: bytes, frame_no: int) -> bytes:
        """Return ``payload`` possibly corrupted/truncated per the schedule.

        Corruption flips one deterministic byte; truncation cuts the payload
        roughly in half.  Receivers must survive both (drop the connection,
        keep the last good state) — that is what the chaos tests assert.
        """
        spec = self._mine(FaultKind.CORRUPT, frame_no)
        if spec is not None and payload:
            i = self._rng.randrange(len(payload))
            self._note(f"corrupt frame={frame_no} byte={i}")
            return payload[:i] + bytes([payload[i] ^ 0xFF]) + payload[i + 1 :]
        spec = self._mine(FaultKind.TRUNCATE, frame_no)
        if spec is not None and len(payload) > 1:
            cut = max(1, len(payload) // 2)
            self._note(f"truncate frame={frame_no} keep={cut}")
            return payload[:cut]
        return payload

    # -- introspection -----------------------------------------------------

    def fired(self, kind: str) -> int:
        """How many times a fault of ``kind`` has fired (from the log)."""
        return sum(1 for line in self.log if line.startswith(kind))
