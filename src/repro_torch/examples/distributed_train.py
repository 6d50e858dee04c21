"""End-to-end driver: train a ~100M-param dense model for a few hundred
steps on one device, with checkpointing, tracing and a final tally +
validation report (the JAX package's ``examples/distributed_train.py``,
in PyTorch).

    PYTHONPATH=src python -m repro_torch.examples.distributed_train [--steps 200] [--device cpu]

(~100M params: 12L × d512 × ff2048 × 32k vocab ≈ 96M.)  Every mode runs
on CUDA unless ``--device cpu`` is given, and raises without a card; the
driver passes ``--device`` on to every worker process it spawns.

``--live`` instead demonstrates the §3.7+§6 streaming aggregation service on
localhost: N worker processes each run a small traced workload, streaming
live tally state (protocol-v2 delta frames) to a *local master* which
forwards the per-rank breakdown to a *global master* (the full fanout tree,
live, rank identities intact).  Each worker also runs an adaptive policy
that retunes its snapshot cadence from the live ``busy_fraction`` of
``train_step`` mid-run.  The driver renders the global composite while the
ranks run — what ``iprof top`` shows — then proves the final live composite
matches the offline ``iprof combine`` of the very same run's per-rank
aggregates, API for API, and that the ``query_ranks`` per-rank sums equal
the merged composite.

With ``--live-slow-rank R`` one rank is deliberately slowed inside its
``train_step`` spans; a **cluster-scope adaptive controller**
(``StragglerRankPolicy`` over the global master's per-rank composites) runs
in the driver, flags the lagging rank from API-level evidence — which rank,
which API, how far behind the cluster median — records the flag as an
``ust_repro:advisory`` event in the driver's own trace, and feeds the
trainer-layer straggler watchdog (``StragglerWatchdog.note_api_evidence``),
the same callback a real ``Trainer`` exposes as ``straggler_callback``.

    PYTHONPATH=src python -m repro_torch.examples.distributed_train --live --live-slow-rank 1

``--chaos`` runs the closed remediation loop over N worker processes with a
seeded fault injector: cluster flags → escalation ladder → checkpoint-and-
drain → evict + re-mesh (or, with ``--chaos-replace``, spawn + restore +
splice of a replacement incarnation), then checks itself and exits non-zero
on any failed check:

    PYTHONPATH=src python -m repro_torch.examples.distributed_train --chaos \
        --inject-fault "slowdown:rank=1,after=5,factor=8"
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import render, tally_trace
from repro_torch.core.plugins.validate import render as vrender, validate_trace
from repro_torch.models import Model, ShapeSpec
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

#: the worker processes run this module: ``python -m`` + its name
MODULE = "repro_torch.examples.distributed_train"


def config_100m():
    base = get_config("h2o-danube-1.8b")
    return dataclasses.replace(
        base,
        name="danube-100m",
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        d_ff=2048,
        vocab_size=32_000,
        head_dim=64,
        sliding_window=1024,
        dtype="float32",
    )


# ---------------------------------------------------------------------------
# --live: multi-process streaming aggregation demo
# ---------------------------------------------------------------------------


def live_worker(
    rank: int,
    out_dir: str,
    addr: str,
    steps: int,
    slow_s: float = 0.0,
    seconds: float = 0.0,
    device: str = "cuda",
) -> None:
    """One traced rank: tiny traced step on ``device``, tally state streamed to ``addr``
    (v2 delta frames in steady state), final aggregate also written to disk
    (aggregate_only) so the driver can cross-check the live composite
    against ``iprof combine``.

    Each worker also runs the §6 adaptive consumer: a cadence policy watches
    the live windowed ``busy_fraction`` of ``train_step`` and retunes the
    snapshot push period mid-run — snapshots arrive fast while the rank is
    compiling/computing, slow while it idles.  Every knob turn is printed
    and recorded as an ``ust_repro:advisory`` event in the trace.

    ``slow_s`` injects extra latency *inside* every ``train_step`` span —
    the synthetic straggler the driver's cluster-scope controller must
    catch from the per-rank composites alone.  With ``seconds`` set the
    worker keeps stepping until that much wall time has passed (at least
    ``steps`` steps), so fast and slow ranks stay *concurrently* active —
    cross-rank windows only exist while ranks overlap.
    """
    from repro_torch.core import (
        AdaptiveController,
        StreamCadencePolicy,
        TracedStep,
        collective_span,
        train_step_span,
    )

    f = TracedStep(lambda x: (x * x).sum(), name="square_sum", device=device)
    x = torch.arange(128.0, device=device) + rank
    ctrl = AdaptiveController(
        [
            StreamCadencePolicy(
                "ust_repro", "train_step", high=0.05, low=0.005, fast_s=0.05, slow_s=0.5
            )
        ],
        period_s=0.1,
        on_action=lambda a: print(f"[rank {rank}] {a}", flush=True),
    )
    cfg = TraceConfig(
        out_dir=out_dir,
        mode="default",
        rank=rank,
        aggregate_only=True,
        stream_to=addr,
        stream_period_s=0.1,
        adaptive=ctrl,
    )
    with Tracer(cfg) as tr:
        deadline = time.monotonic() + seconds
        s = 0
        while s < steps or (seconds > 0 and time.monotonic() < deadline):
            with train_step_span(s, 2, 64) as sp:
                sp.outs["loss"] = float(f(x))
                sp.outs["grad_norm"] = 1.0
                if slow_s > 0:
                    time.sleep(slow_s)  # the injected straggler latency
            with collective_span("all_reduce", 128, "data", 2):
                pass
            time.sleep(0.05)  # spread steps so mid-run snapshots differ
            s += 1
    st = tr.streamer
    print(
        f"[rank {rank}] streamed {st.pushed} frames "
        f"({st.delta_frames} deltas, {st.full_frames} full, {st.bytes_sent} B); "
        f"{len(ctrl.actions)} adaptive knob turns",
        flush=True,
    )


def _api_totals(t):
    """(table, provider, api) → (calls, total_ns); the acceptance currency."""
    out = {}
    for name, table in (("host", t.apis), ("device", t.device_apis)):
        for key, st in table.items():
            out[(name,) + key] = (st.calls, st.total_ns)
    return out


def run_live(args) -> int:
    from repro_torch.core import (
        ClusterAdaptiveController,
        MasterServer,
        StragglerRankPolicy,
        StreamClient,
    )
    from repro_torch.core.aggregate import combine_aggregates, find_aggregates, merge_tallies
    from repro_torch.core.babeltrace import CTFSource
    from repro_torch.core.plugins.tally import Tally, render_by_rank
    from repro_torch.train import StragglerWatchdog

    root = tempfile.mkdtemp(prefix="thapi_live_")
    # Global master at the tree root, one local master forwarding into it —
    # the paper's rank → local master → global master chain, live.  The
    # local master forwards the per-rank breakdown (forward_ranks default),
    # so rank identities survive to the root where the cluster controller
    # reads them.
    global_m = MasterServer(port=0).start()
    local_m = MasterServer(
        port=0, forward_to=global_m.addr, forward_period_s=0.1
    ).start()
    print(f"[live] global master {global_m.addr} ← local master {local_m.addr}")
    # one authenticated-capable client, one pooled connection for every
    # driver-side read of the global master (composite + per-rank breakdown)
    gclient = StreamClient(global_m.addr)

    env = dict(os.environ)
    procs = []
    for r in range(args.live_ranks):
        out = os.path.join(root, f"r{r}")
        cmd = [
            sys.executable,
            "-m",
            MODULE,
            "--device",
            args.device,
            "--live-worker",
            str(r),
            "--live-out",
            out,
            "--live-addr",
            local_m.addr,
            "--live-steps",
            str(args.live_steps),
        ]
        if args.live_seconds:
            cmd += ["--live-worker-seconds", str(args.live_seconds)]
        if args.live_slow_rank is not None and r == args.live_slow_rank:
            cmd += ["--live-slow", str(args.live_slow_s)]
        procs.append(subprocess.Popen(cmd, env=env))
    if args.live_slow_rank is not None:
        print(
            f"[live] rank {args.live_slow_rank} deliberately slowed by "
            f"{args.live_slow_s * 1000:.0f}ms per train_step"
        )

    # Cluster-scope adaptive control in the driver: a StragglerRankPolicy
    # polls the global master's per-rank composites over TCP (query_ranks),
    # flags ranks lagging the cluster median on train_step latency, and
    # feeds the trainer-layer watchdog — the same callback a real Trainer
    # exposes as `trainer.straggler_callback`.
    watchdog = StragglerWatchdog()
    monitor = ClusterAdaptiveController(
        [
            StragglerRankPolicy(
                "ust_repro", "train_step", ratio=1.75, metric="latency", patience=1
            )
        ],
        addr=global_m.addr,
        period_s=0.4,
        on_straggler=watchdog.note_api_evidence,
        on_action=lambda a: print(f"[cluster] {a}", flush=True),
    )

    # The driver runs its own tiny tracing session so every cluster flag is
    # also recorded as a ust_repro:advisory event — the "adaptation is
    # observable" invariant holds at cluster scope too.
    driver_dir = os.path.join(root, "driver")
    print(f"[live] {len(procs)} ranks streaming; composite while they run:")
    with Tracer(TraceConfig(out_dir=driver_dir, mode="default", online=True)) as drv:
        monitor.attach(drv)
        while any(p.poll() is None for p in procs):
            monitor.tick()
            time.sleep(0.2)
            t, meta = gclient.composite()
            if t.apis or t.device_apis:
                print(
                    f"\n[live] -- {meta['sources']} sources, "
                    f"{meta['snapshots']} snapshots --"
                )
                print(render(t, top=5))
    rc = max(p.wait() for p in procs)
    if rc != 0:
        print(f"[live] a worker failed (exit {rc})", file=sys.stderr)
        return rc

    # Final snapshots are pushed at tracer stop; wait for them to propagate
    # up the tree, then compare against the offline batch combine.
    offline = combine_aggregates(find_aggregates(root))
    want = _api_totals(offline)
    deadline = time.time() + 10.0
    live = None
    while time.time() < deadline:
        local_m.flush(force=True)
        live, _ = gclient.composite()
        if _api_totals(live) == want:
            break
        time.sleep(0.2)
    ranks, _ = gclient.ranks()
    gclient.close()
    local_m.stop()
    global_m.stop()

    lst = local_m.stats()
    print(
        f"\n[live] local master ingested {lst['snapshots']} state updates "
        f"({lst['deltas']} deltas, {lst['full_snapshots']} full snapshots, "
        f"{lst['resyncs']} resyncs)"
    )
    print("\n[live] final composite (streaming, via global master):")
    print(render(live))
    print("\n[live] per-rank breakdown at the global master (iprof top --by-rank):")
    print(render_by_rank(ranks))
    print("\n[live] offline combine of the same run's rank aggregates:")
    print(render(offline))

    ok = True
    if _api_totals(live) == want:
        print(
            f"\n[live] OK: live composite matches offline combine "
            f"({len(want)} API rows, {args.live_ranks} ranks)"
        )
    else:
        print("\n[live] MISMATCH between live composite and offline combine", file=sys.stderr)
        ok = False

    # per-rank sums must reproduce the merged composite, API for API
    rank_merge, _ = merge_tallies([Tally().merge(t) for t in ranks.values()])
    if _api_totals(rank_merge) == _api_totals(live):
        print(
            f"[live] OK: query_ranks per-rank sums equal the merged composite "
            f"({len(ranks)} ranks)"
        )
    else:
        print("[live] MISMATCH between per-rank sums and composite", file=sys.stderr)
        ok = False

    if args.live_slow_rank is not None:
        reports = watchdog.api_reports()
        advisories = [
            ev for ev in CTFSource(driver_dir) if ev.name == "ust_repro:advisory"
        ]
        wanted = f"rank{args.live_slow_rank}"
        hit = [r for r in reports if r.source.endswith(wanted)]
        if hit and advisories:
            r = hit[0]
            print(
                f"[live] OK: straggler {r.source} flagged on {r.provider}:{r.api} "
                f"at {r.ratio:.1f}x the cluster median; trainer watchdog got "
                f"{len(reports)} report(s), {len(advisories)} advisory event(s) "
                f"in the driver trace"
            )
        else:
            print(
                f"[live] FAIL: slow rank {wanted} not flagged "
                f"(reports={len(reports)}, advisories={len(advisories)})",
                file=sys.stderr,
            )
            ok = False
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# --chaos: closed-loop remediation demo
#   fault injection → cluster flags → escalation ladder → checkpoint-and-drain
#   → evict + re-mesh → survivors finish the evicted rank's work
# ---------------------------------------------------------------------------


def chaos_worker(
    rank, out_dir, addr, quota, ctl_dir, fault, seed, incarnation=0, src=None, ckpt=None,
    device="cuda",
):
    """One chaos rank: traced step loop with a deterministic FaultInjector,
    periodic (async) checkpoints of its progress, and a control-file channel
    the driver's remediation hooks use to escalate / drain it.

    Commands (one per line, appended to ``ctl/rank<r>.cmd``):
      * ``escalate``  — climb the fidelity ladder (sampled → full);
      * ``drain``     — commit a durable checkpoint, ack, exit cleanly;
      * ``extra:N``   — the re-mesh dealt this rank N orphaned steps; a
                        *negative* N is the splice clawing re-dealt work
                        back for a replacement — the worker returns only
                        what it has not already finished (clamped at
                        ``done``) and acks ``clawed:<returned>:<target>``;
      * ``finish``    — run is over, exit.

    A rank that reaches its quota idles on cheap heartbeat steps (so
    cross-rank windows keep existing — a straggler only lags relative to
    *active* peers) until the driver says ``finish`` or deals it more work.

    With ``incarnation > 0`` this worker is an elastic *replacement*: it
    resumes ``done`` from the newest checkpoint in ``ckpt`` (its dead
    predecessor's drain point) and streams under the predecessor's source
    id ``src`` with the new incarnation — the master atomically swaps the
    per-source state on its first frame and fences the dead incarnation.
    """
    import json

    from repro_torch.checkpoint import Checkpointer, latest_checkpoint
    from repro_torch.core import TracedStep, train_step_span
    from repro_torch.core.faults import FaultInjector, parse_fault_specs

    base_step_s = 0.04
    inj = FaultInjector(parse_fault_specs(fault) if fault else [], rank=rank, seed=seed)
    ck = Checkpointer(ckpt or os.path.join(out_dir, "ckpt"), keep=2)
    cmd_path = os.path.join(ctl_dir, f"rank{rank}.cmd")
    ack_path = os.path.join(ctl_dir, f"rank{rank}.ack")

    def ack(line):
        with open(ack_path, "a") as fh:
            fh.write(line + "\n")

    f = TracedStep(lambda x: (x * x).sum(), name="square_sum", device=device)
    x = torch.arange(64.0, device=device) + rank
    done, target, cmds_seen, idle_acked = 0, quota, 0, -1
    if incarnation:
        path = latest_checkpoint(ck.root)
        if path is not None:
            with open(os.path.join(path, "manifest.json")) as fh:
                done = int(json.load(fh)["extra"]["steps_done"])
        ack(f"restored:{done}:{incarnation}")
    cfg = TraceConfig(
        out_dir=out_dir,
        mode="default",
        fidelity="sampled",  # headroom for the escalate rung (sampled → full)
        sampling_interval=2,  # short run: keep the straggler visible when sampled
        rank=rank,
        aggregate_only=True,
        stream_to=addr,
        stream_period_s=0.1,
        stream_source=src,
        stream_incarnation=incarnation,
    )
    with Tracer(cfg) as tr:
        while True:
            try:
                with open(cmd_path) as fh:
                    lines = [ln.strip() for ln in fh if ln.strip()]
            except OSError:
                lines = []
            finish = False
            for ln in lines[cmds_seen:]:
                cmds_seen += 1
                if ln == "escalate":
                    prev = tr.set_mode("full")
                    ack(f"escalated:{prev}->full")
                elif ln == "drain":
                    ck.wait()
                    ck.save(done, {"w": torch.tensor(float(done))}, extra={"steps_done": done})
                    ack(f"drained:{done}")
                    return  # quiesced: Tracer exit flushes the final aggregate
                elif ln.startswith("extra:"):
                    delta = int(ln.split(":", 1)[1])
                    if delta < 0:
                        # splice claw-back: finished work is never returned
                        old = target
                        target = max(done, target + delta)
                        ack(f"clawed:{old - target}:{target}")
                    else:
                        target += delta
                        ack(f"extra:{target}")
                elif ln == "finish":
                    finish = True
            if finish:
                break
            if done >= target:
                if idle_acked != target:
                    idle_acked = target
                    ack(f"idle:{done}")
                # heartbeat step: keeps this rank in the cross-rank window
                # without advancing its work counter
                with train_step_span(done, 1, 16) as sp:
                    sp.outs["loss"] = 0.0
                    sp.outs["grad_norm"] = 0.0
                    time.sleep(base_step_s)
                continue
            # the span holds the whole modelled step, base_step_s of work:
            # a healthy rank's train_step latency is then tens of ms, which
            # a loaded host's scheduling jitter does not lift 2.5x above
            # the cluster median as it would a span of microseconds
            with train_step_span(done, 1, 16) as sp:
                sp.outs["loss"] = float(f(x))
                sp.outs["grad_norm"] = 1.0
                time.sleep(base_step_s + inj.sleep_s(done, base_step_s))  # SLOWDOWN fault
            if inj.should_hang(done):
                ack(f"hung:{done}")
                time.sleep(600)  # HANG fault: stuck until evicted
            if inj.should_die(done):
                os._exit(17)  # KILL fault: no cleanup, no final aggregate
            done += 1
            if done % 5 == 0:
                ck.save_async(done, {"w": torch.tensor(float(done))}, extra={"steps_done": done})
        ck.wait()
        ck.save(done, {"w": torch.tensor(float(done))}, extra={"steps_done": done})
        ack(f"done:{done}")
    print(f"[rank {rank}] finished {done} steps", flush=True)


def run_chaos(args) -> int:
    import json
    import re

    from repro_torch.checkpoint import latest_checkpoint
    from repro_torch.core import (
        RUNG_DRAIN,
        RUNG_ESCALATE,
        RUNG_EVICT,
        RUNG_REPLACE,
        ClusterAdaptiveController,
        MasterServer,
        RemediationEngine,
        RemediationHooks,
        SickHostPolicy,
        StragglerRankPolicy,
    )
    from repro_torch.core.aggregate import combine_aggregates, find_aggregates
    from repro_torch.core.babeltrace import CTFSource
    from repro_torch.core.plugins.tally import ApiStat, Tally
    from repro_torch.core.stream import SnapshotStreamer
    from repro_torch.launch.elastic import ReplacementManager, WorkerSupervisor
    from repro_torch.launch.mesh import plan_eviction

    nranks, quota = args.chaos_ranks, args.chaos_steps
    root = tempfile.mkdtemp(prefix="thapi_chaos_")
    ctl = os.path.join(root, "ctl")
    os.makedirs(ctl)
    master = MasterServer(port=0).start()
    print(
        f"[chaos] master {master.addr}; {nranks} ranks × {quota} steps; "
        f"fault={args.inject_fault or 'none'}"
        + (" (dry-run: advisory only)" if args.chaos_dry_run else "")
        + (" (elastic: replace instead of evict)" if args.chaos_replace else "")
    )

    procs = {}
    for r in range(nranks):
        open(os.path.join(ctl, f"rank{r}.cmd"), "w").close()
        cmd = [
            sys.executable,
            "-m", MODULE,
            "--device", args.device,
            "--chaos-worker", str(r),
            "--chaos-out", os.path.join(root, f"r{r}"),
            "--chaos-addr", master.addr,
            "--chaos-ctl", ctl,
            "--chaos-quota", str(quota),
            "--chaos-seed", str(args.chaos_seed),
        ]
        if args.inject_fault:
            cmd += ["--chaos-fault", args.inject_fault]
        procs[r] = subprocess.Popen(cmd, env=dict(os.environ))

    def _rank_of(source):
        m = re.search(r"rank(\d+)$", source)
        return int(m.group(1)) if m else -1

    def _send(r, line):
        with open(os.path.join(ctl, f"rank{r}.cmd"), "a") as fh:
            fh.write(line + "\n")

    def _acks(r):
        try:
            with open(os.path.join(ctl, f"rank{r}.ack")) as fh:
                return [ln.strip() for ln in fh if ln.strip()]
        except OSError:
            return []

    def _wait_ack(r, prefix, timeout=10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for ln in _acks(r):
                if ln.startswith(prefix):
                    return ln
            if procs[r].poll() is not None:
                return None
            time.sleep(0.05)
        return None

    # -- remediation hooks: the ladder's rungs, driver-side -----------------------
    drained_steps = {}
    evicted = []
    replaced = set()
    extras = {r: 0 for r in range(nranks)}
    dealt_record = {}  # rank → deal_shares at its eviction/replacement
    out_dirs = {r: os.path.join(root, f"r{r}") for r in range(nranks)}

    def hk_escalate(target, detail):
        _send(_rank_of(target), "escalate")
        return True  # advisory write; the worker applies it at a step boundary

    def hk_drain(target, detail):
        r = _rank_of(target)
        if procs[r].poll() is None and r not in hung:
            _send(r, "drain")
            ln = _wait_ack(r, "drained:")
            if ln is not None:
                drained_steps[r] = int(ln.split(":")[1])
                return True
        # dead / unresponsive rank: "drain" means recovering its last durable
        # checkpoint — that is the state the survivors resume from
        path = latest_checkpoint(os.path.join(root, f"r{r}", "ckpt"))
        if path is None:
            drained_steps[r] = 0
            return True
        with open(os.path.join(path, "manifest.json")) as fh:
            drained_steps[r] = int(json.load(fh)["extra"]["steps_done"])
        return True

    def hk_evict(target, detail):
        r = _rank_of(target)
        if procs[r].poll() is None:
            procs[r].terminate()
            try:
                procs[r].wait(timeout=10)
            except subprocess.TimeoutExpired:
                procs[r].kill()
                procs[r].wait()
        evicted.append(r)
        plan = plan_eviction(nranks, evicted)
        if r in dealt_record:
            # replace rung already dealt this rank's remainder before its
            # spawn chain failed; evicting must not deal it twice
            print(f"[chaos] re-mesh: survivors {plan.survivors} (work already "
                  f"dealt by the failed replace: {dealt_record[r]})")
            return True
        remaining = quota - drained_steps.get(r, 0)
        shares = plan.reassign({r: remaining})
        for s, extra in shares.items():
            if extra:
                extras[s] += extra
                _send(s, f"extra:{extra}")
        print(
            f"[chaos] re-mesh: survivors {plan.survivors}, dense ranks "
            f"{plan.dense_rank}; {remaining} orphaned steps dealt {dict(shares)}"
        )
        return True

    # -- elastic replacement (the ``replace`` rung, --chaos-replace) --------------
    def _spawn_replacement(r, inc):
        """Launch incarnation ``inc`` of rank ``r``: fresh trace dir, the
        predecessor's checkpoint root and source id, the drained step count
        as its base quota (the splice claw-back arrives as ``extra:`` later)."""
        out = os.path.join(root, f"r{r}.i{inc}")
        cmd = [
            sys.executable,
            "-m", MODULE,
            "--device", args.device,
            "--chaos-worker", str(r),
            "--chaos-out", out,
            "--chaos-addr", master.addr,
            "--chaos-ctl", ctl,
            "--chaos-quota", str(drained_steps.get(r, 0)),
            "--chaos-seed", str(args.chaos_seed),
            "--chaos-incarnation", str(inc),
            "--chaos-src", rank_source[r],
            "--chaos-ckpt", os.path.join(root, f"r{r}", "ckpt"),
        ]
        p = subprocess.Popen(cmd, env=dict(os.environ))
        procs[r] = p
        out_dirs[r] = out
        return p

    supervisor = WorkerSupervisor(_spawn_replacement)
    for r, p in procs.items():
        supervisor.register(r, p, incarnation=0)
    manager = ReplacementManager(
        supervisor,
        ckpt_root_for=lambda r: os.path.join(root, f"r{r}", "ckpt"),
        # admitted = the master has ingested a frame from the new incarnation
        # (the atomic per-source swap has happened; the fence is live)
        ready=lambda r, inc: master.incarnation_of(rank_source.get(r, "")) >= inc,
        ready_timeout_s=30.0,
        spawn_retries=1,
        on_event=lambda a, t, d, ok: engine.note(a, t, d, ok),
    )

    def hk_replace(target, detail):
        r = _rank_of(target)
        if rank_source.get(r) is None or r not in drained_steps:
            return False  # source id / drain point not known yet; ladder retries
        d = drained_steps[r]
        plan = plan_eviction(nranks, [r])
        if r not in dealt_record:
            # deal the dead rank's remainder out NOW so survivors keep
            # working while the replacement spawns; the splice claws the
            # un-done part back
            dealt_record[r] = plan.deal_shares(r, quota - d)
            for s, n in dealt_record[r].items():
                extras[s] += n
                _send(s, f"extra:{n}")
            print(
                f"[chaos] replace: {quota - d} orphaned steps dealt "
                f"{dealt_record[r]} while the replacement spawns", flush=True
            )
        res = manager.replace(r, plan, dealt_record[r], reason=detail, target=target)
        if not res.ok:
            return False  # engine retries, then falls through to evict
        returned = 0
        for s, g in res.giveback.items():
            _send(s, f"extra:-{g}")
        for s, g in res.giveback.items():
            ln = _wait_ack(s, "clawed:")
            got = int(ln.split(":")[1]) if ln else 0
            extras[s] -= got
            returned += got
        extras[r] = (d + returned) - quota
        if returned:
            _send(r, f"extra:{returned}")
        replaced.add(r)
        print(
            f"[chaos] replacement rank {r} incarnation {res.incarnation} admitted "
            f"at step {d}; survivors returned {returned} un-done steps; "
            f"mesh back to {len(res.plan.survivors)}/{nranks} ranks", flush=True
        )
        return True

    actions = []
    engine = RemediationEngine(
        RemediationHooks(
            escalate=hk_escalate,
            drain=hk_drain,
            replace=hk_replace if args.chaos_replace else None,
            evict=hk_evict,
        ),
        cooldown_s=0.4,
        escalate_after=2,
        healthy_windows=4,
        dry_run=args.chaos_dry_run,
        max_evictions=1,
        max_replacements=1,
        replace_retries=2,
        on_action=lambda a: (actions.append(a), print(f"[chaos] {a}", flush=True)),
    )
    straggler = StragglerRankPolicy(
        "ust_repro", "train_step", ratio=2.5, metric="latency", patience=1
    )
    sick = SickHostPolicy(patience=2)
    monitor = ClusterAdaptiveController(
        [straggler, sick],
        master=master,
        period_s=0.3,
        on_flag=engine.ingest_flag,
        on_healthy=engine.observe_healthy,
    )

    rank_source = {}  # rank id → stream source id, learned from the master

    def _learn_sources():
        for src in list(master.ranks(copy=False)):
            rank_source.setdefault(_rank_of(src), src)

    hung = set()
    ok = True
    fault_kind = (args.inject_fault or "").split(":", 1)[0]

    driver_dir = os.path.join(root, "driver")
    with Tracer(TraceConfig(out_dir=driver_dir, mode="default", online=True)) as drv:
        engine.attach(drv)
        monitor.attach(drv)
        deadline = time.time() + args.chaos_timeout
        while time.time() < deadline:
            monitor.tick()
            _learn_sources()
            for r in range(nranks):
                for ln in _acks(r):
                    if ln.startswith("hung:"):
                        hung.add(r)
            # Policies flag once, on the excursion's edge; the ladder wants
            # the flag re-asserted every tick while the condition holds —
            # bridge level → edge here.  Dead and drained-but-not-evicted
            # ranks are driver-level evidence the policies can't see.
            for src, ratio in straggler.flagged.items():
                engine.ingest_flag(src, "straggler", f"{ratio:.2f}x median latency")
            for src, ev in sick.flagged.items():
                engine.ingest_flag(src, "sick-host", ev)
            for r, p in procs.items():
                src = rank_source.get(r, f"rank{r}")
                if r not in evicted and p.poll() not in (None, 0):
                    engine.ingest_flag(src, "dead", f"exit {p.poll()}")
                if r in hung and r not in evicted:
                    engine.ingest_flag(src, "hung", "no step progress")
                if (
                    r in drained_steps
                    and r not in evicted
                    and r not in replaced
                    and not args.chaos_dry_run
                ):
                    engine.ingest_flag(src, "drained", "awaiting eviction")
            engine.tick()
            # done when every non-evicted rank is idle at its (possibly
            # re-meshed) target and the injected fault has been dealt with
            settled = True
            for r in range(nranks):
                if r in evicted:
                    continue
                if procs[r].poll() not in (None, 0):
                    # dead but not evicted: unresolved — except in dry-run,
                    # where the ladder only advises and never evicts
                    if not args.chaos_dry_run:
                        settled = False
                    continue
                if r in hung:
                    continue  # can't make progress; eviction is the exit
                want = quota + extras[r]
                idle = [ln for ln in _acks(r) if ln.startswith("idle:")]
                if not (idle and int(idle[-1].split(":")[1]) >= want):
                    settled = False
            if args.chaos_replace:
                # replace mode settles on a successful splice, not an eviction
                if not replaced:
                    settled = False
            elif fault_kind and not args.chaos_dry_run and not evicted:
                settled = False
            if fault_kind and args.chaos_dry_run and not any(
                a.action == RUNG_EVICT and a.dry_run for a in actions
            ):
                settled = False
            if settled:
                break
            time.sleep(0.1)
        else:
            print("[chaos] TIMEOUT waiting for the run to settle", file=sys.stderr)
            ok = False
        for r in range(nranks):
            if r not in evicted and procs[r].poll() is None:
                if r in hung:
                    procs[r].terminate()  # never reads the control file again
                else:
                    _send(r, "finish")
        for r, p in procs.items():
            if r not in evicted:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    ok = False
                    print(f"[chaos] FAIL: rank {r} did not exit on finish",
                          file=sys.stderr)

    # A rank whose first frame landed while a hook held the loop (the
    # replacement's admission wait, seconds under load) is unknown to the
    # loop if the run settles on that same tick: learn the sources again
    # now that every worker has exited and flushed its last frame.
    deadline = time.time() + 5.0
    _learn_sources()
    while time.time() < deadline and not all(
        r in rank_source for r in range(nranks) if find_aggregates(out_dirs[r])
    ):
        time.sleep(0.1)
        _learn_sources()

    # -- verification -------------------------------------------------------------
    # (1) work conservation: survivors' completed steps + the evicted rank's
    # drained progress account for every planned step, re-mesh included
    completed = {}
    for r in range(nranks):
        if r in evicted:
            completed[r] = drained_steps.get(r, 0)
        else:
            done = [ln for ln in _acks(r) if ln.startswith("done:")]
            completed[r] = int(done[-1].split(":")[1]) if done else 0
    total, planned = sum(completed.values()), nranks * quota
    if args.chaos_dry_run and fault_kind in ("kill", "hang"):
        # advisory-only mode never recovers a dead rank's work — by design
        print(f"[chaos] dry-run with {fault_kind}: {total}/{planned} steps "
              f"(lost work is the point: nothing was remediated)")
    elif total == planned:
        print(f"[chaos] OK: {total} steps completed = {nranks} ranks × {quota} planned")
    else:
        print(f"[chaos] FAIL: {total} steps completed != {planned} planned "
              f"(per-rank {completed})", file=sys.stderr)
        ok = False

    # (2) live per-rank state matches the offline fold of the same ranks'
    # aggregates (a killed rank never flushes one — noted and skipped);
    # final frames flush at worker exit, so give them a moment to land
    for r in range(nranks):
        aggs = find_aggregates(out_dirs[r])
        src = rank_source.get(r)
        if not aggs:
            print(f"[chaos] rank {r}: no offline aggregate (died mid-run), skipped")
            continue
        if src is None:
            print(f"[chaos] FAIL: rank {r} has an aggregate but no live state",
                  file=sys.stderr)
            ok = False
            continue
        want = _api_totals(combine_aggregates(aggs))
        deadline = time.time() + 5.0
        match = False
        while time.time() < deadline and not match:
            live = master.ranks().get(src)
            match = live is not None and _api_totals(live) == want
            if not match:
                time.sleep(0.1)
        if match:
            print(f"[chaos] OK: rank {r} live state == offline aggregate")
        else:
            print(f"[chaos] FAIL: rank {r} live state != offline aggregate",
                  file=sys.stderr)
            ok = False

    # (2b) elastic fencing: final healthy rank count, then a zombie frame —
    # the dead incarnation speaking up late with a poison row under the old
    # incarnation number — which the master must fence (fence_rejects > 0)
    # and whose row must never reach the composite
    if args.chaos_replace:
        healthy = sum(
            1 for r, p in procs.items() if r not in evicted and p.poll() == 0
        )
        if healthy == nranks and replaced and not evicted:
            print(f"[chaos] OK: {healthy}/{nranks} ranks healthy at exit "
                  f"(rank {sorted(replaced)[0]} replaced in place, no eviction)")
        else:
            print(f"[chaos] FAIL: {healthy}/{nranks} healthy ranks "
                  f"(replaced={sorted(replaced)}, evicted={evicted})",
                  file=sys.stderr)
            ok = False
        poison = Tally()
        poison.apis[("ust_zombie", "poison")] = ApiStat(
            calls=1, total_ns=10**12, min_ns=10**12, max_ns=10**12
        )
        fenced = 0
        deadline = time.time() + 10.0
        while time.time() < deadline and replaced:
            src = rank_source[sorted(replaced)[0]]
            z = SnapshotStreamer(master.addr, source=src, delta=False)
            try:
                z.push(poison)  # hello carries incarnation 0 < live: fenced
            except Exception:
                pass
            finally:
                z.close()
            fenced = master.stats()["fence_rejects"]
            if fenced:
                break
            time.sleep(0.2)
        poisoned = any(
            ("ust_zombie", "poison") in t.apis for t in master.ranks().values()
        ) or ("ust_zombie", "poison") in master.composite().apis
        if fenced > 0 and not poisoned:
            print(f"[chaos] OK: zombie fenced (fence_rejects={fenced}), "
                  "poison row absent from the composite")
        else:
            print(f"[chaos] FAIL: fence_rejects={fenced}, poisoned={poisoned}",
                  file=sys.stderr)
            ok = False

    # (3) every remediation decision is a trace event, and the ladder held
    # its invariants (drain strictly before evict, dry-run touches nothing)
    trace_events = [
        ev for ev in CTFSource(driver_dir) if ev.name == "ust_repro:remediation"
    ]
    if len(trace_events) == len(actions) and (not fault_kind or actions):
        print(f"[chaos] OK: {len(actions)} remediation decisions, every one traced")
    else:
        print(f"[chaos] FAIL: {len(actions)} decisions but {len(trace_events)} "
              f"trace events", file=sys.stderr)
        ok = False
    if fault_kind:
        names = [a.action for a in actions]
        if args.chaos_dry_run:
            if all(a.dry_run for a in actions) and not evicted and all(
                not _acks(r) or not any(ln.startswith(("escalated", "drained"))
                                        for ln in _acks(r))
                for r in range(nranks)
            ):
                print("[chaos] OK: dry-run — full ladder advised, nothing touched")
            else:
                print("[chaos] FAIL: dry-run had side effects", file=sys.stderr)
                ok = False
        elif args.chaos_replace:
            want_rungs = [RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE]
            if (
                all(w in names for w in want_rungs)
                and names.index(RUNG_DRAIN) < names.index(RUNG_REPLACE)
                and RUNG_EVICT not in names
                and "replace_admit" in names
            ):
                print("[chaos] OK: ladder walked "
                      f"{' → '.join(w for w in want_rungs)} "
                      "(drain before replace, no eviction)")
            else:
                print(f"[chaos] FAIL: ladder order wrong: {names}", file=sys.stderr)
                ok = False
            if engine.replacements == 1 and manager.admitted == 1:
                print(f"[chaos] OK: 1 replacement admitted "
                      f"({manager.spawned} spawn attempt(s)), work clawed back")
            else:
                print(f"[chaos] FAIL: replacements={engine.replacements}, "
                      f"admitted={manager.admitted}", file=sys.stderr)
                ok = False
        else:
            want_rungs = [RUNG_ESCALATE, RUNG_DRAIN, RUNG_EVICT]
            if all(w in names for w in want_rungs) and (
                names.index(RUNG_DRAIN) < names.index(RUNG_EVICT)
            ):
                print("[chaos] OK: ladder walked "
                      f"{' → '.join(w for w in want_rungs)} (drain before evict)")
            else:
                print(f"[chaos] FAIL: ladder order wrong: {names}", file=sys.stderr)
                ok = False
            if len(evicted) == 1 and engine.evicted:
                print(f"[chaos] OK: rank {evicted[0]} evicted, "
                      f"{quota - drained_steps.get(evicted[0], 0)} steps re-dealt")
            else:
                print(f"[chaos] FAIL: eviction did not happen: {evicted}",
                      file=sys.stderr)
                ok = False
    master.stop()
    print("\n[chaos] remediation log:")
    print(engine.render_log() or "  (no actions)")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument(
        "--device",
        default="cuda",
        help="device of the trainer and of every worker process (cuda or cpu)",
    )
    ap.add_argument("--live", action="store_true", help="streaming aggregation demo")
    ap.add_argument("--live-ranks", type=int, default=2)
    ap.add_argument("--live-steps", type=int, default=20)
    ap.add_argument(
        "--live-slow-rank",
        type=int,
        default=None,
        help="slow this rank inside train_step; the cluster controller must flag it",
    )
    ap.add_argument(
        "--live-slow-s",
        type=float,
        default=0.25,
        help="injected per-step latency for --live-slow-rank (seconds)",
    )
    ap.add_argument(
        "--live-seconds",
        type=float,
        default=None,
        help="run every rank for this much wall time (keeps fast and slow "
        "ranks concurrently active; defaults to 6s in slow-rank mode)",
    )
    ap.add_argument("--live-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--live-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--live-addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--live-slow", type=float, default=0.0, help=argparse.SUPPRESS)
    ap.add_argument(
        "--live-worker-seconds", type=float, default=0.0, help=argparse.SUPPRESS
    )
    ap.add_argument(
        "--chaos",
        action="store_true",
        help="closed-loop remediation demo: fault injection → escalation "
        "ladder → checkpoint-and-drain → evict + re-mesh",
    )
    ap.add_argument(
        "--inject-fault",
        default=None,
        help="fault spec(s) for --chaos, e.g. 'slowdown:rank=1,after=5,factor=8' "
        "or 'kill:rank=1,after=8' (';'-separated for several)",
    )
    ap.add_argument("--chaos-ranks", type=int, default=3)
    ap.add_argument("--chaos-steps", type=int, default=25)
    ap.add_argument(
        "--chaos-dry-run",
        action="store_true",
        help="remediation engine advises only: every decision is traced, no "
        "hook runs, nothing is drained or evicted",
    )
    ap.add_argument(
        "--chaos-replace",
        action="store_true",
        help="elastic mode: the remediation ladder replaces the failed rank "
        "(spawn + restore + splice) instead of shrinking the mesh; pair "
        "with a kill fault, e.g. --inject-fault 'kill:rank=1,after=8'",
    )
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-timeout", type=float, default=120.0)
    ap.add_argument("--chaos-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chaos-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chaos-addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chaos-ctl", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chaos-quota", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--chaos-fault", default=None, help=argparse.SUPPRESS)
    ap.add_argument(
        "--chaos-incarnation", type=int, default=0, help=argparse.SUPPRESS
    )
    ap.add_argument("--chaos-src", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chaos-ckpt", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    if args.chaos_worker is not None:
        chaos_worker(
            args.chaos_worker,
            args.chaos_out,
            args.chaos_addr,
            args.chaos_quota,
            args.chaos_ctl,
            args.chaos_fault,
            args.chaos_seed,
            incarnation=args.chaos_incarnation,
            src=args.chaos_src,
            ckpt=args.chaos_ckpt,
            device=args.device,
        )
        return
    if args.chaos:
        sys.exit(run_chaos(args))
    if args.live_worker is not None:
        live_worker(
            args.live_worker,
            args.live_out,
            args.live_addr,
            args.live_steps,
            slow_s=args.live_slow,
            seconds=args.live_worker_seconds,
            device=args.device,
        )
        return
    if args.live and args.live_slow_rank is not None and args.live_seconds is None:
        # straggler detection needs cross-rank windows: ranks must overlap
        args.live_seconds = 6.0
    if args.live:
        sys.exit(run_live(args))

    cfg = config_100m()
    model = Model(cfg)
    print(f"{cfg.name}: {cfg.num_params() / 1e6:.0f}M params on {device}")

    work = tempfile.mkdtemp(prefix="thapi_e2e_")
    with Tracer(TraceConfig(out_dir=work, mode="default", sample=True)):
        trainer = Trainer(
            model,
            ShapeSpec("e2e", "train", args.seq, args.batch),
            device,
            TrainConfig(peak_lr=3e-4, warmup=20, total_steps=args.steps),
            TrainerConfig(
                steps=args.steps, ckpt_every=50, ckpt_dir=work + "/ckpt", log_every=20
            ),
        )
        res = trainer.run()

    h = res["history"]
    print(f"\nloss: {h[0]['loss']:.3f} → {h[-1]['loss']:.3f} over {res['steps_run']} steps")
    print(f"stragglers flagged: {res['straggler_steps']}, failures: {res['failures']}\n")
    print(render(tally_trace(work), top=10))
    print()
    print(vrender(validate_trace(work)))


if __name__ == "__main__":
    main()
