"""The port's remediation engine and fault injector, the twin of
``tests/test_remediation.py`` against ``repro_torch.core.{remediation,faults}``:
ladder mechanics, cooldown and backoff, hysteresis, dry run, traced
decisions, fault specs, ``SickHostPolicy``.  Then exact parity with the JAX
package: the same flag sequence on an injected clock gives the same
decisions from both engines, the same specs, seed and rank give the same
fault decisions, and a port trace of remediation decisions tallies under the
JAX ``tally_trace`` with the JAX engine's rows.

Everything here runs with an injected clock — no sleeps, no wall time."""

import random

import pytest

from repro.core import faults as jax_faults
from repro.core import remediation as jax_remediation
from repro_torch.core.adaptive import ClusterAdaptiveController, SickHostPolicy
from repro_torch.core.faults import FaultInjector, FaultKind, FaultSpec, parse_fault_specs
from repro_torch.core.remediation import (
    RUNG_DRAIN,
    RUNG_ESCALATE,
    RUNG_EVICT,
    RUNG_REPLACE,
    RemediationEngine,
    RemediationHooks,
)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class Recorder:
    """Hook that logs invocations and returns a scripted result."""

    def __init__(self, results=None):
        self.calls = []
        self.results = list(results or [])

    def __call__(self, target, reason):
        self.calls.append((target, reason))
        return self.results.pop(0) if self.results else True


def mk_engine(clock, **kw):
    hooks = RemediationHooks(
        escalate=kw.pop("escalate", Recorder()),
        drain=kw.pop("drain", Recorder()),
        evict=kw.pop("evict", Recorder()),
        restore=kw.pop("restore", None),
    )
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("backoff_cap_s", 4.0)
    kw.setdefault("escalate_after", 2)
    kw.setdefault("healthy_windows", 3)
    return RemediationEngine(hooks, clock=clock, **kw)


def flag_and_tick(eng, clock, src="rank1", n=1, dt=1.0, kind="straggler"):
    out = []
    for _ in range(n):
        eng.ingest_flag(src, kind, "test")
        out += eng.tick(clock.advance(dt))
    return out


# ---------------------------------------------------------------------------
# escalation ladder
# ---------------------------------------------------------------------------


def test_first_flag_fires_cheapest_rung_immediately():
    clock = Clock()
    eng = mk_engine(clock)
    acts = flag_and_tick(eng, clock, n=1)
    assert [a.action for a in acts] == [RUNG_ESCALATE]
    assert eng.rung_of("rank1") == 0
    assert eng.hooks.escalate.calls == [("rank1", "straggler: test")]


def test_sustained_flags_walk_the_full_ladder_in_order():
    clock = Clock()
    eng = mk_engine(clock)
    acts = flag_and_tick(eng, clock, n=8)
    names = [a.action for a in acts]
    assert names == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_EVICT]
    # drain-before-evict: strictly ordered, and each hook ran exactly once
    assert len(eng.hooks.drain.calls) == 1
    assert len(eng.hooks.evict.calls) == 1
    assert eng.evicted == ("rank1",)


def test_unsustained_flag_holds_the_current_rung():
    clock = Clock()
    eng = mk_engine(clock, escalate_after=3)
    flag_and_tick(eng, clock, n=1)  # rung 0
    # alternate flagged/healthy: streak never reaches 3, rung never moves
    for _ in range(6):
        flag_and_tick(eng, clock, n=1)
        eng.observe_healthy("rank1")
        eng.tick(clock.advance(1.0))
    assert eng.rung_of("rank1") <= 0
    assert not eng.hooks.drain.calls


def test_evict_requires_prior_drain():
    clock = Clock()
    # drain hook always fails: the ladder must never reach evict
    eng = mk_engine(clock, drain=Recorder(results=[False] * 50))
    acts = flag_and_tick(eng, clock, n=20, dt=5.0)  # dt > backoff cap
    assert RUNG_EVICT not in [a.action for a in acts]
    assert not eng.hooks.evict.calls
    assert eng.evicted == ()


def test_eviction_budget_caps_evictions():
    clock = Clock()
    eng = mk_engine(clock, max_evictions=1)
    flag_and_tick(eng, clock, "rank1", n=8)
    flag_and_tick(eng, clock, "rank2", n=8)
    assert eng.evicted == ("rank1",)
    assert eng.rung_of("rank2") == 1  # drained, but eviction denied
    assert len(eng.hooks.evict.calls) == 1


def test_evicted_target_is_terminal():
    clock = Clock()
    eng = mk_engine(clock)
    flag_and_tick(eng, clock, n=8)
    before = len(eng.actions)
    flag_and_tick(eng, clock, n=5)  # flags for an evicted rank are ignored
    assert len(eng.actions) == before


# ---------------------------------------------------------------------------
# cooldown and capped-exponential backoff
# ---------------------------------------------------------------------------


def test_cooldown_blocks_refire_within_window():
    clock = Clock()
    eng = mk_engine(clock, cooldown_s=10.0, backoff_cap_s=10.0)
    eng.ingest_flag("rank1")
    assert len(eng.tick(clock.advance(1.0))) == 1
    for _ in range(5):  # 5s elapsed < 10s cooldown: nothing may fire
        eng.ingest_flag("rank1")
        assert eng.tick(clock.advance(1.0)) == []
    eng.ingest_flag("rank1")
    assert [a.action for a in eng.tick(clock.advance(10.0))] == [RUNG_DRAIN]


def test_failed_hook_retries_same_rung_with_capped_backoff():
    clock = Clock()
    drain = Recorder(results=[False, False, False, True])
    eng = mk_engine(clock, drain=drain, cooldown_s=1.0, backoff_cap_s=4.0)
    flag_and_tick(eng, clock, n=1)  # rung 0
    fire_times = []
    for _ in range(40):
        eng.ingest_flag("rank1")
        for a in eng.tick(clock.advance(0.5)):
            if a.action == RUNG_DRAIN:
                fire_times.append(a.ts)
    assert len(fire_times) == 4  # 3 failures + the success
    gaps = [b - a for a, b in zip(fire_times, fire_times[1:])]
    # backoff 2^1, 2^2, then capped at 4.0 (tick grid is 0.5s)
    assert gaps[0] == pytest.approx(2.0, abs=0.5)
    assert gaps[1] == pytest.approx(4.0, abs=0.5)
    assert gaps[2] == pytest.approx(4.0, abs=0.5)
    # the failed attempts are in the audit log, marked failed
    failed = [a for a in eng.actions if a.action == RUNG_DRAIN and not a.ok]
    assert len(failed) == 3
    assert eng.rung_of("rank1") >= 1  # success landed the rung (and may escalate on)


def test_raising_hook_counts_as_failure():
    clock = Clock()

    def boom(target, reason):
        raise RuntimeError("effector exploded")

    eng = mk_engine(clock, escalate=boom)
    acts = flag_and_tick(eng, clock, n=1)
    assert len(acts) == 1 and not acts[0].ok
    assert eng.rung_of("rank1") == -1  # rung not taken


# ---------------------------------------------------------------------------
# hysteresis / de-escalation
# ---------------------------------------------------------------------------


def test_healthy_windows_deescalate_one_rung_at_a_time():
    clock = Clock()
    restore = Recorder()
    eng = mk_engine(clock, restore=restore, healthy_windows=3)
    flag_and_tick(eng, clock, n=4)  # escalate + drain (rung 1)
    assert eng.rung_of("rank1") == 1
    acts = []
    for _ in range(6):
        eng.observe_healthy("rank1")
        acts += eng.tick(clock.advance(1.0))
    assert [a.action for a in acts] == ["deescalate", "recover"]
    assert eng.rung_of("rank1") == -1
    assert restore.calls == [("rank1", "recovered")]


def test_flag_resets_healthy_streak():
    clock = Clock()
    eng = mk_engine(clock, healthy_windows=3)
    flag_and_tick(eng, clock, n=1)
    for _ in range(4):  # healthy, healthy, flag, healthy... never 3 in a row
        eng.observe_healthy("rank1")
        eng.tick(clock.advance(1.0))
        eng.observe_healthy("rank1")
        eng.tick(clock.advance(1.0))
        flag_and_tick(eng, clock, n=1)
    assert eng.rung_of("rank1") == 0  # never de-escalated


# ---------------------------------------------------------------------------
# dry-run mode
# ---------------------------------------------------------------------------


def test_dry_run_never_invokes_hooks_but_logs_everything():
    clock = Clock()
    eng = mk_engine(clock, dry_run=True)
    acts = flag_and_tick(eng, clock, n=10)
    names = [a.action for a in acts]
    # dry-run skips the drained gate, so the advisory ladder reaches evict
    assert RUNG_ESCALATE in names and RUNG_DRAIN in names and RUNG_EVICT in names
    assert all(a.dry_run for a in acts)
    assert not eng.hooks.escalate.calls
    assert not eng.hooks.drain.calls
    assert not eng.hooks.evict.calls
    assert eng.evicted == ()  # advisory eviction doesn't remove anyone


def test_missing_hook_is_advisory_and_ladder_progresses():
    clock = Clock()
    eng = RemediationEngine(None, clock=clock, cooldown_s=1.0, escalate_after=1)
    acts = flag_and_tick(eng, clock, n=5)
    assert [a.action for a in acts] == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_EVICT]
    assert all(a.ok for a in acts)


# ---------------------------------------------------------------------------
# traced decisions
# ---------------------------------------------------------------------------


def test_every_decision_is_a_trace_event(tmp_path):
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.babeltrace import CTFSource

    clock = Clock()
    out = str(tmp_path / "trace")
    with Tracer(TraceConfig(out_dir=out, mode="default")) as tr:
        eng = mk_engine(clock, dry_run=True).attach(tr)
        flag_and_tick(eng, clock, n=10)
        n_actions = len(eng.actions)
    evs = [e for e in CTFSource(out) if e.name == "ust_repro:remediation"]
    assert n_actions > 0 and len(evs) == n_actions


def test_on_action_callback_sees_every_action():
    clock = Clock()
    seen = []
    eng = mk_engine(clock, on_action=seen.append)
    flag_and_tick(eng, clock, n=8)
    assert seen == eng.actions


@pytest.mark.parametrize("own_channels", [False, True])
def test_tracer_closes_the_loop_through_the_cluster_controller(tmp_path, own_channels):
    """``TraceConfig(remediation=engine)`` beside ``cluster_adaptive``: the
    controller's flag and healthy channels feed the engine unless the
    caller wired its own, and the consumer thread's ticks act on a flag."""
    import time

    from repro_torch.core import TraceConfig, Tracer

    own = []
    ctl = ClusterAdaptiveController(
        [], period_s=10.0,
        on_flag=(lambda s, k, d: own.append(s)) if own_channels else None,
    )
    eng = RemediationEngine(None, cooldown_s=0.01, backoff_cap_s=0.01, escalate_after=1)
    with Tracer(TraceConfig(out_dir=str(tmp_path), serve_port=0, cluster_adaptive=ctl, remediation=eng)) as tr:
        assert tr.remediation is eng and tr.cluster is ctl
        assert (ctl.on_flag == eng.ingest_flag) != own_channels
        assert ctl.on_healthy == eng.observe_healthy
        ctl.on_flag("host:1:rank1", "straggler", "3x median")
        deadline = time.monotonic() + 10.0
        while not eng.actions and time.monotonic() < deadline and not own_channels:
            time.sleep(0.01)
    if own_channels:
        assert own == ["host:1:rank1"] and not eng.actions
    else:
        assert [(a.action, a.target) for a in eng.actions] == [(RUNG_ESCALATE, "host:1:rank1")]


# ---------------------------------------------------------------------------
# engine parameter validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {"cooldown_s": 0.0},
        {"cooldown_s": 2.0, "backoff_cap_s": 1.0},
        {"escalate_after": 0},
        {"healthy_windows": 0},
    ],
)
def test_engine_rejects_bad_params(kw):
    with pytest.raises(ValueError):
        RemediationEngine(None, **kw)


# ---------------------------------------------------------------------------
# FaultSpec / FaultInjector
# ---------------------------------------------------------------------------


def test_fault_spec_parse_roundtrip():
    s = FaultSpec.parse("slowdown:rank=1,after=10,factor=8")
    assert (s.kind, s.rank, s.after, s.factor) == ("slowdown", 1, 10, 8.0)
    assert FaultSpec.parse(s.render()) == s
    multi = parse_fault_specs("kill:rank=2,after=5; drop:after=3,p=0.5")
    assert [m.kind for m in multi] == ["kill", "drop"]


@pytest.mark.parametrize(
    "text",
    ["", "frobnicate:rank=1", "slowdown:p=1.5", "slowdown:factor=0", "slowdown:nope"],
)
def test_fault_spec_rejects_bad_input(text):
    with pytest.raises(ValueError):
        FaultSpec.parse(text)


def test_fault_spec_window():
    s = FaultSpec(FaultKind.HANG, after=5, duration=3)
    assert [s.active_at(i) for i in range(4, 9)] == [False, True, True, True, False]


def test_injector_is_rank_scoped_and_deterministic():
    specs = parse_fault_specs("slowdown:rank=1,after=2,factor=5;kill:rank=0,after=7")
    r0 = FaultInjector(specs, rank=0, seed=42)
    r1 = FaultInjector(specs, rank=1, seed=42)
    # rank 0 never slows, dies at 7; rank 1 slows from 2, never dies
    assert [r0.sleep_s(i, 0.01) for i in range(10)] == [0.0] * 10
    assert [i for i in range(10) if r0.should_die(i)] == [7, 8, 9]
    sleeps = [r1.sleep_s(i, 0.01) for i in range(10)]
    assert sleeps[2] == pytest.approx(0.04)
    assert not any(r1.should_die(i) for i in range(10))
    # same seed and same call pattern → identical fault log
    r1b = FaultInjector(specs, rank=1, seed=42)
    assert [r1b.sleep_s(i, 0.01) for i in range(10)] == sleeps
    [r1b.should_die(i) for i in range(10)]
    assert r1b.log == r1.log
    assert r0.fired("kill") == 3 and r1.fired("slowdown") > 0


def test_probabilistic_fault_reproducible_per_seed():
    spec = (FaultSpec(FaultKind.DROP, p=0.5),)
    a = FaultInjector(spec, rank=0, seed=7)
    b = FaultInjector(spec, rank=0, seed=7)
    c = FaultInjector(spec, rank=0, seed=8)
    sched_a = [a.should_drop_connection(i) for i in range(50)]
    sched_b = [b.should_drop_connection(i) for i in range(50)]
    sched_c = [c.should_drop_connection(i) for i in range(50)]
    assert sched_a == sched_b
    assert sched_a != sched_c  # astronomically unlikely to collide
    assert 5 < sum(sched_a) < 45  # p=0.5 actually samples


def test_mangle_frame_corrupt_and_truncate():
    payload = bytes(range(64))
    cor = FaultInjector((FaultSpec(FaultKind.CORRUPT),), rank=0, seed=1)
    out = cor.mangle_frame(payload, 0)
    assert len(out) == len(payload) and out != payload
    assert sum(1 for x, y in zip(out, payload) if x != y) == 1  # one byte flipped
    tru = FaultInjector((FaultSpec(FaultKind.TRUNCATE),), rank=0, seed=1)
    out = tru.mangle_frame(payload, 0)
    assert 1 <= len(out) < len(payload)
    # healthy injector passes payloads through untouched
    clean = FaultInjector((), rank=0, seed=1)
    assert clean.mangle_frame(payload, 0) == payload


# ---------------------------------------------------------------------------
# SickHostPolicy (telemetry-evidence flagging)
# ---------------------------------------------------------------------------


def _controller_with(policy, flags):
    return ClusterAdaptiveController(
        [policy],
        period_s=0.0,
        on_flag=lambda s, k, d: flags.append((s, k, d)),
    )


def _observe(ctl, ranks, telemetry, now):
    ctl.observe(ranks, now, telemetry=telemetry)


def test_sick_host_policy_flags_device_memory_pressure():
    from repro_torch.core.plugins.tally import ApiStat, Tally

    def mk():
        t = Tally()
        st = ApiStat()
        st.add(1000)
        t.apis[("ust_repro", "train_step")] = st
        return t

    flags = []
    pol = SickHostPolicy(patience=2)
    ctl = _controller_with(pol, flags)
    ranks = {"rank0": mk(), "rank1": mk()}
    telem = {
        "rank0": {"mem_in_use": 10, "mem_limit": 100, "host_rss": 100},
        "rank1": {"mem_in_use": 99, "mem_limit": 100, "host_rss": 100},
    }
    for i in range(3):
        _observe(ctl, ranks, telem, float(i))
    assert any(s == "rank1" and k == "sick-host" for s, k, _ in flags)
    assert "rank1" in pol.flagged
    # recovery: pressure drops → flag re-arms with an advisory
    telem["rank1"]["mem_in_use"] = 10
    _observe(ctl, ranks, telem, 4.0)
    assert "rank1" not in pol.flagged


def test_sick_host_policy_needs_quorum_and_patience():
    pol = SickHostPolicy(patience=3, min_ranks=2)
    flags = []
    ctl = _controller_with(pol, flags)
    bad = {"rank0": {"mem_in_use": 99, "mem_limit": 100}}
    _observe(ctl, {}, bad, 0.0)  # one rank: below quorum
    assert not flags and not pol._strikes


# ---------------------------------------------------------------------------
# parity with the JAX package (exact)
# ---------------------------------------------------------------------------


class Scripted:
    """Hook whose answers come from a list: True, False, or "raise"."""

    def __init__(self, results):
        self.results = list(results)
        self.calls = []

    def __call__(self, target, reason):
        self.calls.append((target, reason))
        r = self.results.pop(0) if self.results else True
        if r == "raise":
            raise RuntimeError("effector exploded")
        return r


def _script(name):
    """(engine keywords, hook answers per rung, events) of one scenario.
    Events: ("flag", target, kind), ("healthy", target), ("note", target,
    action), ("tick", dt)."""
    ev = []

    def flags(target, n, dt=1.0, kind="straggler"):
        for _ in range(n):
            ev.extend([("flag", target, kind), ("tick", dt)])

    if name == "ladder":
        flags("rank1", 8)
        return {}, {}, ev
    if name == "backoff":
        flags("rank1", 1)
        flags("rank1", 40, dt=0.5)
        return {"cooldown_s": 1.0, "backoff_cap_s": 4.0}, {"drain": [False, False, False, True]}, ev
    if name == "hysteresis":
        flags("rank1", 4)
        for _ in range(8):
            ev.extend([("healthy", "rank1"), ("tick", 1.0)])
        return {"healthy_windows": 3}, {"restore": [True]}, ev
    if name == "dry_run":
        flags("rank1", 10)
        return {"dry_run": True}, {}, ev
    if name == "raising":
        flags("rank1", 6, dt=5.0)
        return {}, {"escalate": ["raise", True]}, ev
    if name == "budget":
        flags("rank1", 8)
        flags("rank2", 8)
        return {"max_evictions": 1}, {}, ev
    if name == "replace":
        for i in range(12):
            ev.extend([("flag", "rank0", "dead"), ("flag", "rank2", "sick-host"), ("tick", 10.0)])
            if i == 4:
                ev.append(("note", "rank0", "replace_spawn"))
        ev.append(("note", "rank9", "replace_admit"))
        kw = {"escalate_after": 1, "max_replacements": 1, "replace_retries": 2, "max_evictions": 2}
        return kw, {"replace": [False, True, True]}, ev
    # "random-<seed>": flags, healthy windows and notes over three targets,
    # hook answers drawn from the same seed
    rng = random.Random(int(name.split("-")[1]))
    for _ in range(300):
        for target in ("r0", "r1", "r2"):
            u = rng.random()
            if u < 0.45:
                ev.append(("flag", target, rng.choice(("straggler", "dead", "sick-host"))))
            elif u < 0.9:
                ev.append(("healthy", target))
            elif u < 0.93:
                ev.append(("note", target, "replace_spawn"))
        ev.append(("tick", rng.choice((0.25, 0.5, 1.0, 3.0))))
    answers = {
        rung: [rng.choice((True, True, True, False, "raise")) for _ in range(200)]
        for rung in ("escalate", "drain", "replace", "evict", "restore")
    }
    kw = {"escalate_after": rng.randint(1, 3), "healthy_windows": rng.randint(1, 4),
          "max_evictions": 2, "max_replacements": 2, "replace_retries": 1}
    return kw, answers, ev


def _drive(mod, name):
    kw, answers, events = _script(name)
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("backoff_cap_s", 4.0)
    clock = Clock()
    hooks = mod.RemediationHooks(
        **{rung: Scripted(answers.get(rung, ())) for rung in ("escalate", "drain", "replace", "evict", "restore")}
    )
    if name in ("ladder", "backoff", "hysteresis", "dry_run", "raising", "budget"):
        hooks.replace = None  # the reference tests' engines run without the replace rung
    eng = mod.RemediationEngine(hooks, clock=clock, **kw)
    for e in events:
        if e[0] == "flag":
            eng.ingest_flag(e[1], e[2], "evidence")
        elif e[0] == "healthy":
            eng.observe_healthy(e[1])
        elif e[0] == "note":
            eng.note(e[2], e[1], "sub-decision")
        else:
            eng.tick(clock.advance(e[1]))
    log = [(a.ts, a.action, a.target, a.detail, a.rung, a.ok, a.dry_run) for a in eng.actions]
    return log, eng


SCENARIOS = ["ladder", "backoff", "hysteresis", "dry_run", "raising", "budget", "replace",
             "random-0", "random-1", "random-2"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_decides_as_the_jax_engine(name):
    port, peng = _drive(__import__("repro_torch.core.remediation", fromlist=["x"]), name)
    ref, jeng = _drive(jax_remediation, name)
    assert port == ref
    assert len(port) > 0
    assert peng.evicted == jeng.evicted and peng.replacements == jeng.replacements
    assert peng.render_log() == jeng.render_log()
    assert {t: peng.rung_of(t) for t in peng.targets} == {t: jeng.rung_of(t) for t in jeng.targets}


def test_random_scenarios_reach_every_rung():
    """The random scripts above are not all quiet: together they fire every
    rung, failed hooks, de-escalations and recoveries."""
    seen = set()
    for seed in range(3):
        log, _ = _drive(jax_remediation, f"random-{seed}")
        seen |= {(a[1], a[5]) for a in log}
    for action in (RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE, RUNG_EVICT, "deescalate", "recover"):
        assert (action, True) in seen, action
    assert any(not ok for _, ok in seen)


def _fault_decisions(mod, kind, seed, rank):
    specs = mod.parse_fault_specs(
        f"{kind}:rank=-1,after=3,factor=3,p=0.5,duration=20;{kind}:rank=1,after=30,factor=6"
    )
    inj = mod.FaultInjector(specs, rank=rank, seed=seed)
    payload = bytes(range(97))
    ask = {
        "slowdown": lambda i: inj.sleep_s(i, 0.01),
        "hang": inj.should_hang,
        "kill": inj.should_die,
        "drop": inj.should_drop_connection,
        "corrupt": lambda i: inj.mangle_frame(payload, i),
        "truncate": lambda i: inj.mangle_frame(payload, i),
    }[kind]
    return [ask(i) for i in range(51)], list(inj.log), inj.fired(kind)


@pytest.mark.parametrize("kind", FaultKind.ALL)
def test_fault_injector_decides_as_the_jax_injector(kind):
    assert FaultKind.ALL == jax_faults.FaultKind.ALL
    fired = 0
    for seed in (0, 1, 7):
        for rank in (0, 1, 2):
            port = _fault_decisions(__import__("repro_torch.core.faults", fromlist=["x"]), kind, seed, rank)
            ref = _fault_decisions(jax_faults, kind, seed, rank)
            assert port == ref, (seed, rank)
            fired += port[2]
    assert fired > 0


def test_fault_specs_parse_and_render_as_the_jax_package():
    for text in ("slowdown:rank=1,after=10,factor=8", "kill:rank=2,after=5; drop:after=3,p=0.5",
                 "hang:duration=4", "corrupt:p=0.25;truncate:rank=0"):
        port = parse_fault_specs(text)
        ref = jax_faults.parse_fault_specs(text)
        assert [p.render() for p in port] == [r.render() for r in ref]
        assert [p.active_at(i) for p in port for i in range(12)] == [r.active_at(i) for r in ref for i in range(12)]


def _traced_decisions(out, mod, core_mod):
    """One traced session of ``core_mod``'s package: a train-step span and
    then a flag and a tick of ``mod``'s engine, eight times, and a note."""
    clock = Clock()
    with core_mod.Tracer(core_mod.TraceConfig(out_dir=out, mode="default")) as tr:
        eng = mod.RemediationEngine(
            mod.RemediationHooks(drain=Scripted([False, True])), clock=clock, cooldown_s=1.0,
            backoff_cap_s=2.0, escalate_after=1,
        ).attach(tr)
        for step in range(8):
            with core_mod.train_step_span(step, 2, 16) as sp:
                sp.outs["loss"] = 1.0
            eng.ingest_flag("host:1:rank1", "straggler", "2.5x median latency")
            eng.tick(clock.advance(1.0))
        eng.note("replace_admit", "host:1:rank1", "incarnation 1 spliced")
        return len(eng.actions)


def _calls(t):
    return {k: st.calls for k, st in t.apis.items()}, {k: st.calls for k, st in t.device_apis.items()}


def test_port_trace_of_decisions_tallies_as_the_jax_engines(tmp_path):
    """The decisions of both engines, each traced by its own package: the
    JAX ``tally_trace`` folds both traces to the same calls per API, and the
    ``ust_repro:remediation`` records (counter events, which the tally does
    not fold) carry the same event id and the same payloads, row for row."""
    import repro.core as jax_core
    from repro.core.babeltrace import CTFSource as JaxCTFSource
    from repro.core.plugins.tally import tally_trace as jax_tally_trace
    from repro_torch import core as port_core
    from repro_torch.core import remediation as port_remediation
    from repro_torch.core.babeltrace import CTFSource
    from repro_torch.core.plugins.tally import tally_trace

    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    nj = _traced_decisions(jd, jax_remediation, jax_core)
    nt = _traced_decisions(td, port_remediation, port_core)
    assert nj == nt == 5  # escalate, failed drain, drain, evict, the note
    assert _calls(jax_tally_trace(td)) == _calls(jax_tally_trace(jd)) == _calls(tally_trace(td))
    assert _calls(tally_trace(td))[0] == {("ust_repro", "train_step"): 8}

    def rows(source, d):
        evs = [e for e in source(d) if e.name == "ust_repro:remediation"]
        return [e.etype.eid for e in evs], [e.asdict() for e in evs]

    (jeids, jrows), (teids, trows) = rows(JaxCTFSource, jd), rows(JaxCTFSource, td)
    assert teids == jeids and len(set(teids)) == 1
    assert trows == jrows
    assert rows(CTFSource, td) == (teids, trows)
    assert [r["action"] for r in trows] == [RUNG_ESCALATE, RUNG_DRAIN, RUNG_DRAIN, RUNG_EVICT, "replace_admit"]
    assert trows[1]["detail"].startswith("FAILED ")
