"""The port's elastic rank replacement, the twin of ``tests/test_elastic.py``
against ``repro_torch.launch.{mesh,elastic}``: remesh-plan edge cases,
checkpoint discovery, the supervisor/manager spawn-restore-splice chain, the
remediation replace rung, incarnation fencing on the master, source GC, the
trainer rejoin barrier (on a device where the JAX trainer takes a mesh), and
the by-rank tombstone rendering.  Then exact parity with the JAX package:
``plan_eviction`` / ``reassign`` / ``deal_shares`` / ``splice_rank`` give the
same plans, and each package's ``latest_restorable_step`` picks the other's
checkpoints."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer, latest_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.plugins.tally import ApiStat, Tally, render_by_rank
from repro_torch.core.remediation import (
    RUNG_DRAIN,
    RUNG_ESCALATE,
    RUNG_EVICT,
    RUNG_REPLACE,
    RemediationEngine,
    RemediationHooks,
)
from repro_torch.core.stream import (
    MasterServer,
    ServeOptions,
    SnapshotStreamer,
    StreamClient,
)
from repro_torch.launch.elastic import (
    ReplacementManager,
    WorkerSupervisor,
    latest_restorable_step,
)
from repro_torch.launch.mesh import RemeshPlan, plan_eviction
from repro_torch.models import Model, ShapeSpec
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def mk_tally(rank: int, calls: int = 10) -> Tally:
    t = Tally()
    st = ApiStat()
    for i in range(calls):
        st.add(1000 + rank + i)
    t.apis[("ust_repro", "train_step")] = st
    return t


def wait_until(pred, timeout_s=5.0, period_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period_s)
    return pred()


# ---------------------------------------------------------------------------
# RemeshPlan edge cases (plan_eviction / reassign / deal_shares / splice_rank)
# ---------------------------------------------------------------------------


def test_plan_eviction_rank_zero():
    # rank 0 is not special: survivors re-densify from the remaining ids
    plan = plan_eviction(4, [0])
    assert plan.survivors == (1, 2, 3)
    assert plan.dense_rank == {1: 0, 2: 1, 3: 2}
    assert plan.evicted == (0,)


def test_plan_eviction_all_but_one():
    plan = plan_eviction(4, [0, 1, 3])
    assert plan.survivors == (2,)
    assert plan.dense_rank == {2: 0}
    # the whole orphaned load lands on the lone survivor, conserved
    out = plan.reassign({0: 3, 1: 2, 2: 5, 3: 4})
    assert out == {2: 3 + 2 + 5 + 4}


def test_plan_eviction_rejects_empty_mesh_and_bad_ranks():
    with pytest.raises(ValueError):
        plan_eviction(3, [0, 1, 2])  # cannot evict every rank
    with pytest.raises(ValueError):
        plan_eviction(3, [5])  # out of range
    with pytest.raises(ValueError):
        plan_eviction(3, [-1])


def test_plan_eviction_double_evict_is_idempotent():
    # duplicate ids collapse: evicting rank 2 twice is evicting it once
    assert plan_eviction(4, [2, 2]) == plan_eviction(4, [2])


def test_reassign_round_robin_conserves_and_spreads():
    plan = plan_eviction(5, [1, 3])
    pending = {0: 2, 1: 7, 2: 1, 3: 4, 4: 0}
    out = plan.reassign(pending)
    assert set(out) == {0, 2, 4}
    assert sum(out.values()) == sum(pending.values())  # work conserved
    # round-robin: orphan work is spread, not dumped on the first survivor
    extra = {r: out[r] - pending.get(r, 0) for r in out}
    assert max(extra.values()) - min(extra.values()) <= 1


def test_deal_shares_matches_reassign_and_rejects_survivors():
    plan = plan_eviction(4, [1])
    dealt = plan.deal_shares(1, 7)
    assert sum(dealt.values()) == 7
    assert set(dealt) <= set(plan.survivors)
    assert all(n > 0 for n in dealt.values())  # zero shares are elided
    assert plan.deal_shares(1, 0) == {}
    with pytest.raises(ValueError):
        plan.deal_shares(0, 5)  # rank 0 was not evicted


def test_splice_rank_giveback_and_restored_topology():
    plan = plan_eviction(4, [1])
    dealt = plan.deal_shares(1, 6)  # {0: 2, 2: 2, 3: 2}
    new_plan, giveback = plan.splice_rank(1, dealt, done_extra={0: 1, 2: 5})
    # finished work is never clawed back; over-done shares clamp to zero
    assert giveback == {0: 1, 3: 2}
    assert new_plan.survivors == (0, 1, 2, 3)
    assert new_plan.evicted == ()
    assert new_plan.dense_rank == {0: 0, 1: 1, 2: 2, 3: 3}


def test_splice_rank_rejects_bad_inputs():
    plan = plan_eviction(4, [1])
    with pytest.raises(ValueError):
        plan.splice_rank(0, {})  # rank 0 was never evicted
    with pytest.raises(ValueError):
        plan.splice_rank(1, {1: 3})  # dealt share names a non-survivor


def test_splice_conservation_identity():
    # the end-to-end identity the chaos harness asserts: for any survivor
    # progress, dealt-out minus clawed-back equals what the survivors keep
    plan = plan_eviction(3, [2])
    dealt = plan.deal_shares(2, 9)
    for done in ({}, {0: 1}, {0: 5, 1: 4}, {0: 100}):
        _, giveback = plan.splice_rank(2, dealt, done)
        kept = {
            s: min(int(done.get(s, 0)), dealt[s]) for s in dealt
        }
        assert sum(giveback.values()) + sum(kept.values()) == 9


# ---------------------------------------------------------------------------
# latest_restorable_step (manifest-only checkpoint discovery)
# ---------------------------------------------------------------------------


def _save_steps(root, steps):
    ck = Checkpointer(str(root), keep=10)
    for s in steps:
        ck.save(s, {"w": torch.arange(8.0)}, extra={"steps_done": s})
    return ck


def test_latest_restorable_missing_dir():
    assert latest_restorable_step("/nonexistent/nowhere") is None


def test_latest_restorable_picks_newest(tmp_path):
    _save_steps(tmp_path, [2, 5, 3])
    path, step = latest_restorable_step(str(tmp_path))
    assert step == 5 and path.endswith("step_5")
    # agrees with the checkpointer's own discovery
    assert latest_checkpoint(str(tmp_path)) == path


def test_latest_restorable_skips_corrupt_manifest(tmp_path):
    _save_steps(tmp_path, [2, 5])
    with open(tmp_path / "step_5" / "manifest.json", "w") as f:
        f.write("{not json")
    path, step = latest_restorable_step(str(tmp_path))
    assert step == 2 and path.endswith("step_2")


def test_latest_restorable_skips_truncated_leaf(tmp_path):
    _save_steps(tmp_path, [2, 5])
    with open(tmp_path / "step_5" / "w.npy", "wb") as f:
        f.write(b"x")  # far below the manifest's nbytes
    path, step = latest_restorable_step(str(tmp_path))
    assert step == 2


# ---------------------------------------------------------------------------
# WorkerSupervisor / ReplacementManager (fake process handles)
# ---------------------------------------------------------------------------


class FakeProc:
    """Quacks like subprocess.Popen for the supervisor."""

    def __init__(self, alive=True):
        self.rc = None if alive else 1
        self.terminated = 0

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated += 1
        if self.rc is None:
            self.rc = -15

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


def test_supervisor_incarnation_monotone():
    spawned = []

    def spawn(rank, inc):
        p = FakeProc()
        spawned.append((rank, inc))
        return p

    sup = WorkerSupervisor(spawn)
    p0 = FakeProc()
    sup.register(3, p0)
    assert sup.incarnation(3) == 0 and sup.alive(3)
    h1, inc1 = sup.spawn_replacement(3)
    h2, inc2 = sup.spawn_replacement(3)
    assert (inc1, inc2) == (1, 2)
    assert spawned == [(3, 1), (3, 2)]
    assert sup.handle(3) is h2  # latest incarnation owns the slot
    assert sup.ranks() == (3,)


def test_supervisor_doa_spawn_burns_its_number():
    sup = WorkerSupervisor(lambda r, i: FakeProc(alive=False))
    sup.register(0, FakeProc())
    _, inc1 = sup.spawn_replacement(0)
    _, inc2 = sup.spawn_replacement(0)
    # a spawn that dies instantly still consumed its incarnation: the fence
    # stays strictly monotone across retries
    assert (inc1, inc2) == (1, 2)
    assert not sup.alive(0)


def test_supervisor_terminate_is_idempotent():
    sup = WorkerSupervisor(lambda r, i: FakeProc())
    p = FakeProc()
    sup.register(1, p)
    sup.terminate(1)
    sup.terminate(1)  # already dead: no-op, no raise
    assert p.terminated == 1
    sup.terminate(99)  # unknown rank: no-op


def test_replacement_manager_success_path():
    events = []
    sup = WorkerSupervisor(lambda r, i: FakeProc())
    sup.register(1, FakeProc(alive=False))
    mgr = ReplacementManager(
        sup,
        ready=lambda r, i: True,
        on_event=lambda a, t, d, ok: events.append((a, t, ok)),
    )
    plan = plan_eviction(4, [1])
    dealt = plan.deal_shares(1, 6)
    res = mgr.replace(1, plan, dealt, done_extra={0: 1}, target="rank1")
    assert res.ok and res.incarnation == 1 and res.attempts == 1
    assert res.plan.survivors == (0, 1, 2, 3)
    assert res.giveback == {0: dealt[0] - 1, 2: dealt[2], 3: dealt[3]}
    assert (mgr.spawned, mgr.admitted, mgr.failed) == (1, 1, 0)
    assert [a for a, _, _ in events] == ["replace_spawn", "replace_admit"]
    assert all(t == "rank1" for _, t, _ in events)


def test_replacement_manager_gives_up_after_retries():
    events = []
    sup = WorkerSupervisor(lambda r, i: FakeProc(alive=False))
    sup.register(2, FakeProc(alive=False))
    mgr = ReplacementManager(
        sup,
        ready=lambda r, i: True,
        spawn_retries=1,
        on_event=lambda a, t, d, ok: events.append((a, ok)),
    )
    plan = plan_eviction(3, [2])
    res = mgr.replace(2, plan, plan.deal_shares(2, 4))
    assert not res.ok and res.plan is None and res.giveback == {}
    assert res.attempts == 2  # 1 + spawn_retries
    assert "died during startup" in res.detail
    assert (mgr.spawned, mgr.admitted, mgr.failed) == (2, 0, 1)
    assert events[-1] == ("replace_giveup", False)
    # both failed incarnations burned their numbers
    assert sup.incarnation(2) == 2


def test_replacement_manager_ready_timeout_fake_clock():
    clk = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        clk[0] += s

    sup = WorkerSupervisor(lambda r, i: FakeProc())
    sup.register(0, FakeProc())
    mgr = ReplacementManager(
        sup,
        ready=lambda r, i: False,
        ready_timeout_s=2.0,
        poll_s=0.5,
        spawn_retries=0,
        clock=lambda: clk[0],
        sleep=sleep,
    )
    plan = plan_eviction(2, [0])
    res = mgr.replace(0, plan, plan.deal_shares(0, 2))
    assert not res.ok and "not ready within" in res.detail
    assert slept  # the injected clock drove the poll loop, not wall time


def test_replacement_manager_restore_point(tmp_path):
    _save_steps(tmp_path, [3, 7])
    sup = WorkerSupervisor(lambda r, i: FakeProc())
    mgr = ReplacementManager(sup, ckpt_root_for=lambda r: str(tmp_path))
    path, step = mgr.restore_point(0)
    assert step == 7 and path.endswith("step_7")
    # no checkpoint root → fresh start, reported as -1
    assert ReplacementManager(sup).restore_point(0) == (None, -1)
    missing = ReplacementManager(sup, ckpt_root_for=lambda r: str(tmp_path / "no"))
    assert missing.restore_point(0) == (None, -1)


# ---------------------------------------------------------------------------
# RemediationEngine replace rung
# ---------------------------------------------------------------------------


def _mk_engine(clk, hooks, **kw):
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("backoff_cap_s", 1.0)
    kw.setdefault("escalate_after", 1)
    return RemediationEngine(hooks, clock=lambda: clk[0], **kw)


def _walk(engine, clk, target, ticks):
    for _ in range(ticks):
        clk[0] += 10.0
        engine.ingest_flag(target, "straggler", "p99 3x")
        engine.tick()


def test_engine_skips_replace_rung_without_hook():
    clk = [0.0]
    fired = []
    hooks = RemediationHooks(
        escalate=lambda t, r: fired.append(RUNG_ESCALATE) or True,
        drain=lambda t, r: fired.append(RUNG_DRAIN) or True,
        evict=lambda t, r: fired.append(RUNG_EVICT) or True,
    )
    engine = _mk_engine(clk, hooks)
    _walk(engine, clk, "r0", 4)
    # no replace hook: drain escalates straight to evict, pre-elastic shape
    assert fired == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_EVICT]
    assert [a.action for a in engine.actions] == fired
    assert engine.evicted == ("r0",)
    assert engine.replacements == 0


def test_engine_replace_fires_after_drain_and_resets_target():
    clk = [0.0]
    fired = []
    hooks = RemediationHooks(
        escalate=lambda t, r: True,
        drain=lambda t, r: True,
        replace=lambda t, r: fired.append(t) or True,
        evict=lambda t, r: True,
    )
    engine = _mk_engine(clk, hooks)
    _walk(engine, clk, "r1", 3)
    assert fired == ["r1"]
    names = [a.action for a in engine.actions]
    assert names == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE]
    # the replacement is a new process: its ladder history starts fresh
    assert engine.rung_of("r1") == -1
    assert engine.actions[-1].rung == -1
    assert engine.replacements == 1
    assert engine.evicted == ()
    # the next incident walks the ladder from the bottom again
    _walk(engine, clk, "r1", 1)
    assert engine.actions[-1].action == RUNG_ESCALATE


def test_engine_replace_budget_zero_goes_straight_to_evict():
    clk = [0.0]
    hooks = RemediationHooks(
        escalate=lambda t, r: True,
        drain=lambda t, r: True,
        replace=lambda t, r: True,
        evict=lambda t, r: True,
    )
    engine = _mk_engine(clk, hooks, max_replacements=0)
    _walk(engine, clk, "r0", 3)
    names = [a.action for a in engine.actions]
    assert names == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_EVICT]
    assert engine.replacements == 0


def test_engine_replace_budget_spent_second_incident_evicts():
    clk = [0.0]
    hooks = RemediationHooks(
        escalate=lambda t, r: True,
        drain=lambda t, r: True,
        replace=lambda t, r: True,
        evict=lambda t, r: True,
    )
    engine = _mk_engine(clk, hooks, max_replacements=1)
    _walk(engine, clk, "r0", 3)  # escalate, drain, replace (budget spent)
    _walk(engine, clk, "r0", 3)  # escalate, drain, evict (over budget)
    names = [a.action for a in engine.actions]
    assert names == [
        RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE,
        RUNG_ESCALATE, RUNG_DRAIN, RUNG_EVICT,
    ]
    assert engine.replacements == 1 and engine.evicted == ("r0",)


def test_engine_failed_replace_falls_through_to_evict():
    clk = [0.0]
    attempts = []
    hooks = RemediationHooks(
        escalate=lambda t, r: True,
        drain=lambda t, r: True,
        replace=lambda t, r: attempts.append(t) and False,
        evict=lambda t, r: True,
    )
    engine = _mk_engine(clk, hooks, replace_retries=1)
    _walk(engine, clk, "r0", 5)
    # replace fired 1 + replace_retries times, then the ladder gave up on
    # replacement and evicted — the drained precondition still held
    assert len(attempts) == 2
    names = [a.action for a in engine.actions]
    assert names == [
        RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE, RUNG_REPLACE, RUNG_EVICT,
    ]
    assert not engine.actions[2].ok and not engine.actions[3].ok
    assert engine.evicted == ("r0",) and engine.replacements == 0


def test_engine_replace_requires_drain_first():
    clk = [0.0]
    hooks = RemediationHooks(
        escalate=lambda t, r: True,
        drain=lambda t, r: False,  # drain keeps failing
        replace=lambda t, r: True,
        evict=lambda t, r: True,
    )
    engine = _mk_engine(clk, hooks)
    _walk(engine, clk, "r0", 4)
    names = [a.action for a in engine.actions]
    # never past drain: replace shares evict's drained precondition
    assert RUNG_REPLACE not in names and RUNG_EVICT not in names


def test_engine_dry_run_advises_replace_rung():
    clk = [0.0]
    engine = _mk_engine(clk, None, dry_run=True)
    _walk(engine, clk, "r0", 4)
    names = [a.action for a in engine.actions]
    assert names == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE, RUNG_EVICT]
    assert all(a.dry_run for a in engine.actions)
    # advisory only: nothing actually replaced or evicted
    assert engine.replacements == 0 and engine.evicted == ()


def test_engine_note_lands_in_audit_log():
    clk = [0.0]
    seen = []
    engine = _mk_engine(clk, None, on_action=seen.append)
    act = engine.note("replace_spawn", "rankX", "incarnation 1 attempt 1")
    assert act.rung == -1 and act.ok  # unknown target: healthy rung
    engine.ingest_flag("r0")
    engine.tick(10.0)
    act2 = engine.note("replace_admit", "r0", "spliced")
    assert act2.rung == engine.rung_of("r0")
    assert [a.action for a in engine.actions] == [
        "replace_spawn", RUNG_ESCALATE, "replace_admit",
    ]
    assert seen == engine.actions


# ---------------------------------------------------------------------------
# Master fencing, source GC, and tombstones
# ---------------------------------------------------------------------------


def test_master_fences_lower_incarnation_snapshot():
    m = MasterServer(port=0)
    assert m.incarnation_of("r0") == -1  # unknown source
    assert m.submit("r0", mk_tally(0, calls=3), incarnation=1)
    assert m.incarnation_of("r0") == 1
    # a zombie's late frame: dropped, counted, state untouched
    assert not m.submit("r0", mk_tally(0, calls=99), incarnation=0)
    assert m.fence_rejects == 1
    st = m.composite().apis[("ust_repro", "train_step")]
    assert st.calls == 3


def test_master_higher_incarnation_swaps_state_atomically():
    m = MasterServer(port=0)
    assert m.submit("r0", mk_tally(0, calls=10), incarnation=0)
    # the replacement's first frame replaces the whole per-source state —
    # never merged with the predecessor's contribution
    assert m.submit("r0", mk_tally(0, calls=3), incarnation=1)
    assert m.incarnation_of("r0") == 1
    st = m.composite().apis[("ust_repro", "train_step")]
    assert st.calls == 3
    assert m.fence_rejects == 0


def test_master_delta_chain_breaks_across_incarnations():
    m = MasterServer(port=0)
    t1 = mk_tally(0, calls=2)
    assert m.submit("r0", Tally().merge(t1), seq=0, gen=7, incarnation=1)
    t2 = mk_tally(0, calls=5)
    delta = t2.delta_to(t1)
    # zombie delta: fenced, no resync path
    assert not m.submit_delta("r0", delta, seq=1, base_seq=0, gen=7, incarnation=0)
    assert m.fence_rejects == 1
    # newer incarnation without a snapshot base: chain mismatch, not fenced
    assert not m.submit_delta("r0", delta, seq=1, base_seq=0, gen=7, incarnation=2)
    assert m.fence_rejects == 1
    # the live incarnation's chain applies cleanly
    assert m.submit_delta("r0", delta, seq=1, base_seq=0, gen=7, incarnation=1)
    st = m.composite().apis[("ust_repro", "train_step")]
    assert st.calls == 5


def test_zombie_hello_is_fenced_over_the_socket():
    with MasterServer(port=0) as m:
        live = SnapshotStreamer(m.addr, source="rZ", incarnation=1)
        t = mk_tally(0, calls=4)
        assert live.push(t)
        assert wait_until(lambda: m.incarnation_of("rZ") == 1)
        # the predecessor process reconnects: fenced at hello, told why,
        # and politely stops for good (the fence is monotone)
        zombie = SnapshotStreamer(m.addr, source="rZ", incarnation=0, retry_s=0.01)
        poison = mk_tally(0, calls=1000)
        for _ in range(200):
            zombie.push(poison)
            if zombie.fenced:
                break
            time.sleep(0.02)
        assert zombie.fenced >= 1
        assert m.fence_rejects >= 1
        assert zombie.push(poison) is False  # permanently stopped
        st = m.composite().apis[("ust_repro", "train_step")]
        assert st.calls == 4  # the poison never reached the composite
        live.close()
        zombie.close()


def test_source_gc_collects_long_dead_sources():
    m = MasterServer(port=0, options=ServeOptions(source_ttl_s=0.3))
    assert m.submit("dead", mk_tally(0))
    time.sleep(0.5)
    assert m.submit("live", mk_tally(1))  # ingest triggers the throttled sweep
    assert wait_until(lambda: "dead" not in m.ranks(), timeout_s=2.0)
    assert "live" in m.ranks()
    assert m.stats()["source_gc"] == 1


def test_retire_and_unretire_visible_to_clients():
    with MasterServer(port=0) as m:
        assert m.submit("r0", mk_tally(0))
        assert m.submit("r1", mk_tally(1))
        assert not m.retire_source("ghost")  # unknown source
        assert m.retire_source("r0")
        with StreamClient(m.addr) as c:
            _, meta = c.ranks()
        assert "r0" in meta["retired"]
        # the replacement's first frame un-retires the row
        assert m.submit("r0", mk_tally(0, calls=2), incarnation=1)
        with StreamClient(m.addr) as c:
            ranks, meta = c.ranks()
        assert "r0" not in meta.get("retired", [])
        assert meta["incarnations"]["r0"] == 1
        assert set(ranks) == {"r0", "r1"}


# ---------------------------------------------------------------------------
# Trainer rejoin barrier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def device():
    return torch.device("cpu")


@pytest.fixture(scope="module")
def smoke_model():
    return Model(get_config("stablelm-3b").smoke())


SHAPE = ShapeSpec("t", "train", 32, 4)


def mk_trainer(smoke_model, device, tmp, steps=8, **kw):
    return Trainer(
        smoke_model,
        SHAPE,
        device,
        TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100),
        TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=str(tmp), **kw),
    )


def test_admit_replacement_restores_and_extends(smoke_model, device, tmp_path):
    # predecessor: run to 8, checkpointing along the way, then drain
    t = mk_trainer(smoke_model, device, tmp_path / "a", steps=8)
    t.run()
    t.checkpoint_and_drain()
    assert t.drained
    # replacement incarnation: restore, clear the drain latch, take back
    # the clawed work as extra step budget
    t2 = mk_trainer(smoke_model, device, tmp_path / "a", steps=8)
    restored = t2.admit_replacement(incarnation=1, extra_steps=3)
    assert restored == 8
    assert t2.incarnation == 1
    assert not t2.drained and not t2.draining.is_set()
    assert t2.cfg.steps == 11
    res = t2.run()
    assert res["steps_run"] == 3 and t2.step == 11


def test_admit_replacement_rejects_negative_incarnation(smoke_model, device, tmp_path):
    t = mk_trainer(smoke_model, device, tmp_path / "b", steps=4)
    with pytest.raises(ValueError):
        t.admit_replacement(incarnation=-1)


# ---------------------------------------------------------------------------
# Restore racing save_async
# ---------------------------------------------------------------------------


def test_restore_races_concurrent_save_async(tmp_path):
    """A replacement restoring while the predecessor's async saver is still
    committing must only ever see self-consistent checkpoints (atomic
    rename + retention GC can remove a dir mid-read, but never tear one)."""
    root = str(tmp_path / "race")
    ck = Checkpointer(root, keep=2)
    stop = threading.Event()

    def writer():
        for s in range(1, 30):
            if stop.is_set():
                break
            ck.save_async(s, {"w": np.full(16, float(s))}, extra={"steps_done": s})
        ck.wait()

    wt = threading.Thread(target=writer)
    wt.start()
    reader = Checkpointer(root, keep=2)
    successes = 0
    try:
        deadline = time.monotonic() + 20.0
        while wt.is_alive() and time.monotonic() < deadline:
            path = latest_checkpoint(root)
            if path is None:
                continue
            try:
                tree, man = reader.restore(path, {"w": np.zeros(16)})
            except Exception:
                continue  # the dir was GC'd mid-read: allowed, just retry
            # every successful restore is internally consistent
            assert float(tree["w"][0]) == float(man.extra["steps_done"])
            successes += 1
    finally:
        stop.set()
        wt.join()
    assert successes > 0


# ---------------------------------------------------------------------------
# By-rank rendering: incarnation suffix + tombstones
# ---------------------------------------------------------------------------


def test_render_by_rank_elastic_annotations():
    ranks = {"r0": mk_tally(0, calls=5), "r1": mk_tally(1, calls=5)}
    out = render_by_rank(ranks, incarnations={"r1": 2}, retired=["r0"])
    assert "r1#2" in out  # replacement: never merges with its predecessor
    assert "r0 [evicted]" in out  # tombstone, totals still counted
    assert "(1 live, 1 evicted)" in out
    plain = render_by_rank(ranks)
    assert "[evicted]" not in plain and "#" not in plain
    assert "2 ranks" in plain


# ---------------------------------------------------------------------------
# parity with the JAX package (exact)
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # world size, evicted, pending work per rank, survivors' progress on the dealt shares
    (4, [0], {0: 5, 1: 2, 2: 0, 3: 1}, {1: 1}),
    (4, [1], {1: 6}, {0: 1, 2: 5}),
    (5, [1, 3], {0: 2, 1: 7, 2: 1, 3: 4, 4: 0}, {0: 3, 4: 1}),
    (3, [2], {2: 9}, {0: 100}),
    (8, [7, 0, 3], {r: r + 1 for r in range(8)}, {1: 2, 2: 1, 6: 9}),
    (4, [0, 1, 3], {0: 3, 1: 2, 2: 5, 3: 4}, {}),
    (2, [1], {1: 0}, {0: 1}),
]


def _plan_view(mod, world, evicted, pending, done):
    plan = mod.plan_eviction(world, evicted)
    out = {"plan": (plan.world_size, plan.evicted, plan.survivors, plan.dense_rank),
           "reassign": plan.reassign(pending), "splices": {}}
    for r in plan.evicted:
        dealt = plan.deal_shares(r, pending.get(r, 0))
        new, giveback = plan.splice_rank(r, dealt, done)
        out["splices"][r] = (dealt, (new.world_size, new.evicted, new.survivors, new.dense_rank), giveback)
    return out


@pytest.mark.parametrize("world,evicted,pending,done", PLAN_CASES)
def test_remesh_plans_match_the_jax_package(world, evicted, pending, done):
    from repro.launch import mesh as jax_mesh
    from repro_torch.launch import mesh as port_mesh

    assert _plan_view(port_mesh, world, evicted, pending, done) == _plan_view(jax_mesh, world, evicted, pending, done)


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.plan_eviction(3, [0, 1, 2]),
        lambda m: m.plan_eviction(3, [5]),
        lambda m: m.plan_eviction(3, [-1]),
        lambda m: m.plan_eviction(4, [1]).deal_shares(0, 5),
        lambda m: m.plan_eviction(4, [1]).splice_rank(0, {}),
        lambda m: m.plan_eviction(4, [1]).splice_rank(1, {1: 3}),
    ],
)
def test_remesh_plans_refuse_what_the_jax_package_refuses(call):
    from repro.launch import mesh as jax_mesh
    from repro_torch.launch import mesh as port_mesh

    for mod in (jax_mesh, port_mesh):
        with pytest.raises(ValueError):
            call(mod)


def _worker_checkpoints(root, steps):
    """What a port chaos worker leaves: ``{"w": done}`` with ``steps_done``."""
    ck = Checkpointer(str(root), keep=10)
    for s in steps:
        ck.save(s, {"w": torch.tensor(float(s))}, extra={"steps_done": s})


def _jax_worker_checkpoints(root, steps):
    """What a JAX chaos worker leaves."""
    from repro.checkpoint import Checkpointer as JaxCheckpointer

    ck = JaxCheckpointer(str(root), keep=10)
    for s in steps:
        ck.save(s, {"w": np.float32(s)}, extra={"steps_done": s})


@pytest.mark.parametrize("damage", [False, True])
def test_jax_discovery_picks_a_port_workers_checkpoint(tmp_path, damage):
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    from repro.checkpoint import latest_checkpoint as jax_latest_checkpoint
    from repro.launch.elastic import latest_restorable_step as jax_latest_restorable_step

    _worker_checkpoints(tmp_path, [2, 5, 3])
    want = 5
    if damage:  # the newest is truncated: both skip to the next-older one
        with open(tmp_path / "step_5" / "w.npy", "wb") as f:
            f.write(b"x")
        want = 3
    path, step = jax_latest_restorable_step(str(tmp_path))
    assert step == want and path.endswith(f"step_{want}")
    assert latest_restorable_step(str(tmp_path)) == (path, step)
    assert jax_latest_checkpoint(str(tmp_path)) == path == latest_checkpoint(str(tmp_path))
    tree, man = JaxCheckpointer(str(tmp_path)).restore(path, {"w": np.float32(0)})
    assert float(tree["w"]) == float(want) and man.extra["steps_done"] == want


@pytest.mark.parametrize("damage", [False, True])
def test_port_discovery_picks_a_jax_workers_checkpoint(tmp_path, damage):
    from repro.launch.elastic import latest_restorable_step as jax_latest_restorable_step

    _jax_worker_checkpoints(tmp_path, [4, 9, 6])
    want = 9
    if damage:  # the newest manifest is unreadable
        with open(tmp_path / "step_9" / "manifest.json", "w") as f:
            f.write("{not json")
        want = 6
    path, step = latest_restorable_step(str(tmp_path))
    assert step == want and path.endswith(f"step_{want}")
    assert jax_latest_restorable_step(str(tmp_path)) == (path, step)
    assert latest_checkpoint(str(tmp_path)) == path
    tree, man = Checkpointer(str(tmp_path)).restore(path, {"w": torch.zeros(())})
    assert float(tree["w"]) == float(want) and man.extra["steps_done"] == want
