"""Elastic rank replacement: spawn, restore, and splice workers into a live mesh.

Without it the remediation ladder ends at eviction — a sick rank is
drained, terminated, and its remainder re-dealt to survivors, permanently
shrinking the mesh.  At scale node failure is a steady-state condition, so the loop
must close: this module spawns a *replacement incarnation* of the evicted
logical rank, restores it from the latest undamaged checkpoint, and splices
it back via :meth:`repro_torch.launch.mesh.RemeshPlan.splice_rank` (the
replacement claws back exactly the un-done re-dealt remainder — work
conservation is preserved through evict → splice as an identity).

Two layers, both process-model-agnostic (any handle with ``poll`` /
``terminate`` / ``kill`` / ``wait`` works — ``subprocess.Popen``, a fake in
tests, a scheduler shim on a real cluster):

* :class:`WorkerSupervisor` — owns the worker handles and the per-rank
  **incarnation counter**.  Every spawn of a logical rank gets a strictly
  larger incarnation; the streaming tier fences frames from superseded
  incarnations (docs/streaming.md §incarnations), so a zombie of the old
  process can never corrupt the composite no matter how late its frames
  arrive.
* :class:`ReplacementManager` — the policy layer the remediation engine's
  ``replace`` hook drives: pick the restore point, terminate the old
  incarnation, spawn the new one (capped retries), wait for it to become
  ready, and compute the splice.  Every spawn / admit / give-up decision is
  reported through ``on_event`` — wired to
  :meth:`repro_torch.core.remediation.RemediationEngine.note`, the decisions land
  in the audit log and the trace as ``ust_repro:remediation`` events like
  any other rung.

Nothing here touches a device (as in ``launch/mesh.py``): checkpoint
*discovery* is manifest-reading only; the replacement process itself
restores device state on its side of the fence.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, Optional, Tuple

from .mesh import RemeshPlan

__all__ = [
    "WorkerSupervisor",
    "ReplacementManager",
    "ReplacementResult",
    "latest_restorable_step",
]

_STEP_RE = re.compile(r"^step_(\d+)$")

#: ``on_event`` callback signature: (action, target, detail, ok)
EventFn = Callable[[str, str, str, bool], None]


def latest_restorable_step(ckpt_root: str) -> Optional[Tuple[str, int]]:
    """Newest structurally-sound checkpoint under ``ckpt_root``.

    Returns ``(path, step)`` or None.  Mirrors the checkpointer's
    newest-first damaged-dir skip (parseable manifest, every leaf file
    present at full payload size) without importing torch or the
    checkpoint package — replacement *planning* must stay runnable on a
    driver host with no accelerator stack.  The JAX package's
    checkpointer writes the same manifest and ``step_<n>`` directories, so
    either package's checkpoints are found.
    """
    if not os.path.isdir(ckpt_root):
        return None
    steps = []
    for name in os.listdir(ckpt_root):
        m = _STEP_RE.match(name)
        if m:
            steps.append((int(m.group(1)), os.path.join(ckpt_root, name)))
    for step, path in sorted(steps, reverse=True):
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                man = json.load(f)
            ok = all(
                os.path.isfile(os.path.join(path, leaf["file"]))
                and os.path.getsize(os.path.join(path, leaf["file"]))
                >= int(leaf["nbytes"])
                for leaf in man["leaves"]
            )
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if ok:
            return path, int(man.get("step", step))
    return None


class WorkerSupervisor:
    """Owns worker process handles and the per-rank incarnation counter.

    ``spawn`` is the launch callable: ``spawn(rank, incarnation) -> handle``
    where the handle quacks like ``subprocess.Popen`` (``poll()`` → None
    while alive, ``terminate()``, ``kill()``, ``wait(timeout)``).  The
    supervisor never invents incarnation numbers out of thin air: rank r's
    first registration is incarnation 0 (the original launch) and every
    :meth:`spawn_replacement` bumps it by one — strictly monotone per rank,
    which is exactly what the master's fencing relies on.
    """

    def __init__(self, spawn: Callable[[int, int], object]):
        self._spawn = spawn
        self._handles: Dict[int, object] = {}
        self._incarnation: Dict[int, int] = {}

    def register(self, rank: int, handle: object, incarnation: int = 0) -> None:
        """Adopt an already-running worker (the original launch path)."""
        self._handles[int(rank)] = handle
        self._incarnation[int(rank)] = int(incarnation)

    def handle(self, rank: int) -> Optional[object]:
        return self._handles.get(int(rank))

    def incarnation(self, rank: int) -> int:
        """Current incarnation of ``rank`` (0 = original, never spawned)."""
        return self._incarnation.get(int(rank), 0)

    def alive(self, rank: int) -> bool:
        h = self._handles.get(int(rank))
        return h is not None and h.poll() is None

    def ranks(self) -> Tuple[int, ...]:
        return tuple(sorted(self._handles))

    def terminate(self, rank: int, timeout_s: float = 5.0) -> None:
        """Best-effort stop of the current incarnation: TERM, wait, KILL.

        Idempotent and tolerant of already-dead processes — the common case
        *is* a dead process (that is why it is being replaced)."""
        h = self._handles.get(int(rank))
        if h is None:
            return
        try:
            if h.poll() is None:
                h.terminate()
                try:
                    h.wait(timeout=timeout_s)
                except Exception:
                    h.kill()
                    try:
                        h.wait(timeout=timeout_s)
                    except Exception:
                        pass
        except Exception:
            pass

    def spawn_replacement(self, rank: int) -> Tuple[object, int]:
        """Launch the next incarnation of ``rank``; returns (handle, inc).

        The incarnation is bumped *before* the spawn, so even a spawn that
        dies instantly has burned its number — a later retry gets a fresh
        one and the fence stays strictly monotone."""
        inc = self._incarnation.get(int(rank), 0) + 1
        self._incarnation[int(rank)] = inc
        handle = self._spawn(int(rank), inc)
        self._handles[int(rank)] = handle
        return handle, inc


@dataclasses.dataclass(frozen=True)
class ReplacementResult:
    """Outcome of one :meth:`ReplacementManager.replace` attempt chain."""

    ok: bool
    rank: int
    incarnation: int          # incarnation admitted (or last one attempted)
    restored_step: int        # checkpoint step the replacement restores from (-1 = none)
    checkpoint: Optional[str]  # restore-point path (None = fresh start)
    plan: Optional[RemeshPlan]  # post-splice topology (None on failure)
    giveback: Dict[int, int]  # survivor id → steps clawed back
    attempts: int             # spawn attempts consumed
    detail: str


class ReplacementManager:
    """Spawn-restore-splice policy for the remediation ``replace`` rung.

    Parameters:

    * ``supervisor`` — the :class:`WorkerSupervisor` owning the handles;
    * ``ckpt_root_for`` — rank → checkpoint root directory (None: the
      replacement starts fresh and the restore point is reported as -1);
    * ``ready`` — ``(rank, incarnation) -> bool`` admission predicate,
      polled until True or ``ready_timeout_s``.  This is where the driver
      checks "the master has seen a frame from the new incarnation" /
      "the worker ack'd its restore" — whatever *ready* means for the
      deployment.  None admits as soon as the process is alive;
    * ``spawn_retries`` — extra spawn attempts after the first (a chain of
      ``1 + spawn_retries`` attempts before giving up — the remediation
      engine then falls through to plain eviction);
    * ``on_event`` — decision sink (``RemediationEngine.note``): every
      spawn, admit, and give-up is observable, per the audit invariant.
    """

    def __init__(
        self,
        supervisor: WorkerSupervisor,
        *,
        ckpt_root_for: Optional[Callable[[int], str]] = None,
        ready: Optional[Callable[[int, int], bool]] = None,
        ready_timeout_s: float = 30.0,
        poll_s: float = 0.1,
        spawn_retries: int = 2,
        on_event: Optional[EventFn] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if ready_timeout_s <= 0 or poll_s <= 0:
            raise ValueError("ready_timeout_s and poll_s must be > 0")
        if spawn_retries < 0:
            raise ValueError("spawn_retries must be >= 0")
        self.supervisor = supervisor
        self.ckpt_root_for = ckpt_root_for
        self.ready = ready
        self.ready_timeout_s = ready_timeout_s
        self.poll_s = poll_s
        self.spawn_retries = spawn_retries
        self.on_event = on_event
        self.clock = clock
        self.sleep = sleep
        self.spawned = 0   # spawn attempts issued
        self.admitted = 0  # replacements that reached ready + splice
        self.failed = 0    # replace() calls that gave up

    def _note(self, action: str, target: str, detail: str, ok: bool = True) -> None:
        if self.on_event is not None:
            try:
                self.on_event(action, target, detail, ok)
            except Exception:
                pass  # observability must never break the replacement

    def restore_point(self, rank: int) -> Tuple[Optional[str], int]:
        """(checkpoint path, step) the replacement of ``rank`` restores from."""
        if self.ckpt_root_for is None:
            return None, -1
        found = latest_restorable_step(self.ckpt_root_for(int(rank)))
        if found is None:
            return None, -1
        return found

    def _await_ready(self, rank: int, inc: int, handle: object) -> Tuple[bool, str]:
        deadline = self.clock() + self.ready_timeout_s
        while True:
            rc = None
            try:
                rc = handle.poll()
            except Exception:
                pass
            if rc is not None:
                return False, f"replacement died during startup (exit {rc})"
            if self.ready is None or self.ready(rank, inc):
                return True, ""
            if self.clock() >= deadline:
                return False, f"not ready within {self.ready_timeout_s:.1f}s"
            self.sleep(self.poll_s)

    def replace(
        self,
        rank: int,
        plan: RemeshPlan,
        dealt: Dict[int, int],
        done_extra: Optional[Dict[int, int]] = None,
        reason: str = "",
        target: Optional[str] = None,
    ) -> ReplacementResult:
        """Run the full spawn → ready → splice chain for ``rank``.

        ``plan`` is the post-eviction topology; ``dealt`` the shares its
        ``reassign`` handed each survivor (``plan.deal_shares``);
        ``done_extra`` how much of those shares is already finished.  On
        success the returned plan has ``rank`` spliced back in and
        ``giveback`` says exactly what each survivor returns.  On failure
        (spawn chain exhausted) ``ok=False`` — the caller (the remediation
        engine's replace hook) falls through to plain eviction.
        """
        tgt = target if target is not None else f"rank{rank}"
        ckpt, step = self.restore_point(rank)
        last_inc = self.supervisor.incarnation(rank)
        attempts = 0
        detail = ""
        for attempt in range(1 + self.spawn_retries):
            self.supervisor.terminate(rank)
            handle, inc = self.supervisor.spawn_replacement(rank)
            last_inc = inc
            attempts += 1
            self.spawned += 1
            self._note(
                "replace_spawn",
                tgt,
                f"incarnation {inc} attempt {attempts} restore step {step}"
                + (f" ({reason})" if reason else ""),
            )
            ok, detail = self._await_ready(rank, inc, handle)
            if ok:
                new_plan, giveback = plan.splice_rank(rank, dealt, done_extra)
                self.admitted += 1
                clawed = sum(giveback.values())
                self._note(
                    "replace_admit",
                    tgt,
                    f"incarnation {inc} spliced, {clawed} steps clawed back "
                    f"from {len(giveback)} survivors",
                )
                return ReplacementResult(
                    ok=True,
                    rank=rank,
                    incarnation=inc,
                    restored_step=step,
                    checkpoint=ckpt,
                    plan=new_plan,
                    giveback=giveback,
                    attempts=attempts,
                    detail="admitted",
                )
            self._note(
                "replace_spawn", tgt, f"incarnation {inc} failed: {detail}", ok=False
            )
            self.supervisor.terminate(rank)
        self.failed += 1
        self._note(
            "replace_giveup",
            tgt,
            f"gave up after {attempts} spawn attempts: {detail}",
            ok=False,
        )
        return ReplacementResult(
            ok=False,
            rank=rank,
            incarnation=last_inc,
            restored_step=step,
            checkpoint=ckpt,
            plan=None,
            giveback={},
            attempts=attempts,
            detail=detail or "spawn attempts exhausted",
        )
