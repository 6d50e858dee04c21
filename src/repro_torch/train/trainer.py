"""Fault-tolerant training loop, fully THAPI-instrumented (the JAX
package's ``train/trainer.py`` on one device: it takes a ``device`` where
the JAX trainer takes a ``Partitioner``).

This is the paper's subject *and* its substrate: every phase of the loop is
traced through the interception layer (train_step / data_next / optimizer
/ checkpoint spans, telemetry step-rate gauge), so iprof tally/timeline on a
training run reproduces the paper's §4.3 analysis on our own stack.

Fault tolerance (1000-node posture, exercised in tests):
  * checkpoint every ``ckpt_every`` steps (async commit), data state included;
  * on startup, auto-restore from the newest valid checkpoint;
  * step execution wrapped in a retry loop: a transient failure restores the
    last checkpoint and replays (``max_failures`` budget);
  * straggler watchdog (:class:`StragglerWatchdog`): EWMA of step wall time
    flags locally-slow steps, and cluster-scope adaptive control
    (``ClusterAdaptiveController`` + ``StragglerRankPolicy`` over the live
    per-rank composites) feeds **API-level evidence** — which rank, which
    API, how far behind the cluster median — into the same watchdog via
    ``trainer.straggler_callback`` (on a real cluster this triggers rank
    replacement — here it feeds the trace and the run report);
  * the state lives on one device and is updated in place; a restore
    copies the checkpoint into it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import Checkpointer, list_checkpoints
from repro_torch.core.interception import data_next_span, optimizer_update_span, train_step_span
from repro_torch.core.telemetry import StepRateGauge
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.models import Model, ShapeSpec
from repro_torch.train.train_step import TrainConfig, build_train_step, init_state


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 50
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    max_failures: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


@dataclasses.dataclass
class StragglerReport:
    """API-level straggler evidence from cluster-scope adaptive control:
    which rank lagged, on which traced API, how far behind the cluster
    median, and the policy's reasoning."""

    source: str  # rank identity (host:pid:rankN)
    provider: str
    api: str
    ratio: float  # rank metric / cluster median
    reason: str = ""


class StragglerWatchdog:
    """The trainer's straggler state, fed by two evidence channels.

    * **Wall clock** (local): :meth:`observe_step` keeps an EWMA of step
      time; a step slower than ``factor`` × EWMA counts as a slow step.
      This knows *that* this rank had a slow step — never *why*, and never
      whether the slowness is this rank's fault or a collective stalled on
      someone else.
    * **API level** (cluster): :meth:`note_api_evidence` matches the
      ``on_straggler`` callback signature of ``ClusterAdaptiveController``
      — cluster-scope policies watching the live per-rank composites report
      the lagging rank, the API it lags on, and the skew ratio.  Reports
      accumulate in :attr:`reports` (thread-safe: the cluster controller
      ticks on the tracer's consumer thread while the step loop runs).

    On a real cluster the combination drives rank replacement; here it
    feeds the trace and the run report, which is exactly the paper's
    "comprehensive tracing lets you *act* on performance problems" loop.
    """

    def __init__(self, factor: float = 3.0, decay: float = 0.9):
        self.factor = factor
        self.decay = decay
        self.slow_steps = 0
        self.reports: List[StragglerReport] = []
        self._ewma: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def ewma_s(self) -> Optional[float]:
        """Current step-time EWMA in seconds (None before the first step)."""
        return self._ewma

    def observe_step(self, dt_s: float) -> bool:
        """Feed one step's wall time; True when it counted as a slow step."""
        slow = self._ewma is not None and dt_s > self.factor * self._ewma
        if slow:
            self.slow_steps += 1
        self._ewma = (
            dt_s
            if self._ewma is None
            else self.decay * self._ewma + (1.0 - self.decay) * dt_s
        )
        return slow

    def note_api_evidence(
        self, source: str, provider: str, api: str, ratio: float, reason: str = ""
    ) -> None:
        """Ingest one cluster-scope straggler report (``on_straggler`` hook)."""
        with self._lock:
            self.reports.append(
                StragglerReport(source, provider, api, float(ratio), reason)
            )

    def api_reports(self) -> List[StragglerReport]:
        """Snapshot of the API-level evidence received so far."""
        with self._lock:
            return list(self.reports)


class Trainer:
    def __init__(
        self,
        model: Model,
        shape: ShapeSpec,
        device,
        tcfg: TrainConfig,
        cfg: TrainerConfig,
        rng_seed: int = 0,
    ):
        self.model = model
        self.shape = shape
        self.device = torch.device(device)
        self.tcfg = tcfg
        self.cfg = cfg
        model.check_trainable()
        self.step_fn = build_train_step(model, shape, tcfg, self.device)
        self.state = init_state(model, tcfg, torch.Generator(device=self.device).manual_seed(rng_seed))
        self.pipe = SyntheticPipeline(model, shape, cfg.data, dp_rank=0, dp_size=1)
        self.ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self.watchdog = StragglerWatchdog(factor=cfg.straggler_factor)
        self.failures = 0
        # -- drain machinery (remediation rung 2) --
        #: set (from any thread) to ask the loop to checkpoint-and-drain at
        #: the next step boundary instead of running to cfg.steps
        self.draining = threading.Event()
        #: True once a drain checkpoint has been durably committed — the
        #: remediation ladder requires this before evicting the rank
        self.drained = False
        #: quiesce hooks: called (in order, exceptions contained) after the
        #: drain checkpoint commits — stop data pipelines, close streams,
        #: release device handles before the host is taken away
        self.on_drain: List[Callable[[], None]] = []
        #: which incarnation of this logical rank the loop is running as —
        #: bumped by :meth:`admit_replacement`; the streaming layer fences
        #: frames from lower incarnations (zombie containment)
        self.incarnation = 0

    @property
    def straggler_steps(self) -> int:
        """Wall-clock-slow steps counted by the watchdog's EWMA channel."""
        return self.watchdog.slow_steps

    @property
    def straggler_callback(self) -> Callable[[str, str, str, float, str], None]:
        """The ``on_straggler`` hook for a ``ClusterAdaptiveController``:
        API-level straggler evidence lands in this trainer's watchdog."""
        return self.watchdog.note_api_evidence

    # -- checkpoint/restore ------------------------------------------------------
    def _maybe_restore(self) -> None:
        if self.ckpt is None:
            return
        # walk newest → oldest: a damaged restore point (truncated leaf,
        # corrupt manifest, failed CRC) falls back to the next-older one
        # instead of killing the run
        for path in list_checkpoints(self.ckpt.root):
            try:
                # read to host memory, then copy into the state on the
                # device: the card never holds two states at once
                restored, man = self.ckpt.restore(path, self.state, device="cpu")
            except Exception:
                continue
            tree.copy_into(self.state, restored)
            self.step = man.step
            if "data" in man.extra:
                self.pipe.load_state_dict(man.extra["data"])
            return

    def _save(self) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save_async(self.step, self.state, extra={"data": self.pipe.state_dict()})

    # -- checkpoint-and-drain (remediation rung 2) --------------------------------
    def request_drain(self) -> None:
        """Ask the running loop to drain at the next step boundary.

        Thread-safe: this is what a :class:`~repro_torch.core.remediation.
        RemediationEngine` drain hook calls from the tracer's consumer
        thread while the step loop runs.  It only sets an event: the drain
        checkpoint is written by :meth:`run`'s own thread at the step
        boundary, so the hook neither blocks the consumer's flushes for the
        length of a save nor touches the device from a second thread.
        """
        self.draining.set()

    def checkpoint_and_drain(self) -> Optional[str]:
        """Quiesce the trainer: commit a durable checkpoint of the current
        state, run the quiesce hooks, and mark the rank drained.

        Returns the committed checkpoint path (None without a checkpointer —
        the rank still quiesces, it just has nothing durable to hand over).
        Idempotent: a second call re-commits but hooks run once per drain.
        The remediation ladder's *drain-before-evict* invariant is anchored
        on :attr:`drained` turning True here and nowhere else.
        """
        self.draining.set()
        path = None
        if self.ckpt is not None:
            self.ckpt.wait()  # join any in-flight async commit first
            path = self.ckpt.save(
                self.step, self.state, extra={"data": self.pipe.state_dict()}
            )
        already = self.drained
        self.drained = True
        if not already:
            for hook in list(self.on_drain):
                try:
                    hook()
                except Exception:
                    pass  # quiesce hooks must not block the drain
        return path

    # -- elastic rejoin (remediation rung: replace) -------------------------------
    def admit_replacement(self, incarnation: int, extra_steps: int = 0) -> int:
        """Rejoin barrier for a replacement incarnation of this rank.

        Called in the replacement process before :meth:`run`: restores from
        the newest undamaged checkpoint (normally the predecessor's drain
        checkpoint), clears the drain latch the predecessor tripped, records
        the new ``incarnation`` (its fencing credential on the stream), and
        extends the step budget by ``extra_steps`` — the work the mesh
        splice clawed back from the survivors.  Returns the restored step.
        """
        inc = int(incarnation)
        if inc < 0:
            raise ValueError("incarnation must be >= 0")
        if self.ckpt is not None:
            self.ckpt.wait()  # never race an in-flight async commit
        self._maybe_restore()
        self.draining.clear()
        self.drained = False
        self.incarnation = inc
        if extra_steps:
            self.cfg.steps += int(extra_steps)
        return self.step

    # -- batching -----------------------------------------------------------------
    def _device_batch(self, host_batch: Dict[str, np.ndarray]):
        # one device: the host batch is the global batch
        return {k: torch.from_numpy(v).to(self.device) for k, v in host_batch.items()}

    # -- main loop -----------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        self._maybe_restore()
        start = self.step
        while self.step < self.cfg.steps and not self.draining.is_set():
            try:
                self._one_step()
            except Exception:
                self.failures += 1
                if self.failures > self.cfg.max_failures or self.ckpt is None:
                    raise
                # fault tolerance: restore + replay
                try:
                    self.ckpt.wait()
                except Exception:
                    self.failures += 1  # a failed async commit also burns budget
                    if self.failures > self.cfg.max_failures:
                        raise
                self._maybe_restore()
        if self.draining.is_set():
            # drain requested mid-run: durable checkpoint + quiesce hooks,
            # then hand back early with drained=True
            self.checkpoint_and_drain()
        elif self.ckpt is not None:
            self.ckpt.wait()
            self._save()
            self.ckpt.wait()
        self.pipe.stop()
        return {
            "steps_run": self.step - start,
            "final_loss": self.history[-1]["loss"] if self.history else float("nan"),
            "straggler_steps": self.straggler_steps,
            "straggler_reports": self.watchdog.api_reports(),
            "failures": self.failures,
            "drained": self.drained,
            "history": self.history,
        }

    def _one_step(self) -> None:
        t0 = time.monotonic()
        with data_next_span(self.step) as dsp:
            host_batch = next(self.pipe)
            batch = self._device_batch(host_batch)
            dsp.outs["tokens"] = int(np.prod(host_batch["tokens"].shape))
        with train_step_span(
            self.step, self.shape.global_batch, self.shape.seq_len
        ) as sp:
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            sp.outs["loss"] = loss
            sp.outs["grad_norm"] = gnorm
        with optimizer_update_span(self.step) as osp:
            osp.outs["lr"] = float(metrics["lr"])
        StepRateGauge.bump()
        self.step += 1
        self.history.append({"step": self.step, "loss": loss, "grad_norm": gnorm})
        if self.ckpt is not None and self.step % self.cfg.ckpt_every == 0:
            self._save()
        # straggler watchdog (EWMA of step wall time; API-level evidence
        # arrives asynchronously via straggler_callback)
        self.watchdog.observe_step(time.monotonic() - t0)
