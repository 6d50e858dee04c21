"""PyTorch port, the fault-tolerant trainer: twins of the JAX package's
trainer tests (``test_train_serve.py``; drain and replacement from
``test_resilience.py`` and ``test_elastic.py``; the straggler watchdog
from ``test_cluster.py``), on the CPU at the smoke
width of stablelm-3b, fp32.  The port's trainer takes a device where the
JAX one takes a partitioner.  A resumed run's last loss equals the straight
run's within 1e-5 relative, as in the JAX test."""

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint import latest_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import Model, ShapeSpec
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

SHAPE = ShapeSpec("t", "train", 32, 4)


@pytest.fixture(scope="module")
def smoke_model():
    return Model(get_config("stablelm-3b").smoke())


def mk_trainer(smoke_model, tmp, steps=8, **kw):
    return Trainer(
        smoke_model,
        SHAPE,
        "cpu",
        TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100),
        TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=str(tmp) if tmp is not None else None, **kw),
    )


def test_loss_decreases(smoke_model, tmp_path):
    res = mk_trainer(smoke_model, tmp_path / "a", steps=10).run()
    assert res["steps_run"] == 10
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in res["history"])


def test_checkpoint_resume_bitwise(smoke_model, tmp_path):
    """Run 8 steps straight vs 4 + restart + 4 — final loss must match."""
    r1 = mk_trainer(smoke_model, tmp_path / "one", steps=8).run()
    mk_trainer(smoke_model, tmp_path / "two", steps=4).run()
    r3 = mk_trainer(smoke_model, tmp_path / "two", steps=8).run()
    assert r3["steps_run"] == 4  # resumed from step 4
    assert r1["history"][-1]["loss"] == pytest.approx(r3["history"][-1]["loss"], rel=1e-5)


def test_trainer_recovers_from_transient_failure(smoke_model, tmp_path):
    t = mk_trainer(smoke_model, tmp_path / "f", steps=8)
    orig = t.step_fn
    calls = {"n": 0}

    class Flaky:
        def __call__(self, state, batch):
            calls["n"] += 1
            if calls["n"] == 6:
                raise RuntimeError("injected node failure")
            return orig(state, batch)

    t.step_fn = Flaky()
    res = t.run()
    assert res["failures"] == 1
    assert t.step == 8  # finished despite the fault


def test_replay_after_a_failure_gives_the_straight_runs_state(smoke_model, tmp_path):
    """The state is updated in place, so a restore must copy the checkpoint
    back over it: the replayed run ends on the straight run's weights."""
    straight = mk_trainer(smoke_model, tmp_path / "s", steps=8)
    straight.run()
    t = mk_trainer(smoke_model, tmp_path / "r", steps=8)
    orig, calls = t.step_fn, {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        out = orig(state, batch)  # the step ran and wrote the state ...
        if calls["n"] == 6:
            raise RuntimeError("injected failure after the update")  # ... then failed
        return out

    t.step_fn = flaky
    t.run()
    for a, b in zip(tree.leaves(t.state), tree.leaves(straight.state), strict=True):
        assert torch.equal(a, b)


def test_trainer_straggler_callback_feeds_run_report(smoke_model, tmp_path):
    t = mk_trainer(smoke_model, tmp_path / "s", steps=4)
    t.straggler_callback("host:7:rank3", "ust_repro", "train_step", 2.7, "2.70x cluster median")
    res = t.run()
    assert res["steps_run"] == 4
    reps = res["straggler_reports"]
    assert len(reps) == 1
    assert reps[0].source == "host:7:rank3" and reps[0].api == "train_step"
    assert reps[0].ratio == pytest.approx(2.7)
    assert res["straggler_steps"] == t.watchdog.slow_steps


def test_trainer_gives_up_after_max_failures(smoke_model, tmp_path):
    t = mk_trainer(smoke_model, tmp_path / "g", steps=8, max_failures=1)

    def always_fail(state, batch):
        raise RuntimeError("permanent failure")

    t.step_fn = always_fail
    with pytest.raises(RuntimeError, match="permanent"):
        t.run()


def test_grad_compression_step_still_learns(smoke_model):
    t = Trainer(
        smoke_model,
        SHAPE,
        "cpu",
        TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100, grad_compression=True),
        TrainerConfig(steps=8, ckpt_every=100, ckpt_dir=None),
    )
    res = t.run()
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]


def test_drain_midrun_checkpoints_and_stops(smoke_model, tmp_path):
    t = mk_trainer(smoke_model, tmp_path / "d", steps=20)
    drained_at = []
    t.on_drain.append(lambda: drained_at.append(t.step))
    orig = t.step_fn

    def drain_at_3(state, batch):
        if t.step == 3:
            t.request_drain()
        return orig(state, batch)

    t.step_fn = drain_at_3
    res = t.run()
    assert res["drained"] is True and res["steps_run"] < 20
    path = latest_checkpoint(str(tmp_path / "d"))
    assert path is not None and path.endswith(f"step_{t.step}")
    assert drained_at == [t.step]
    res2 = mk_trainer(smoke_model, tmp_path / "d", steps=t.step + 2).run()
    assert res2["steps_run"] == 2 and res2["drained"] is False


def test_admit_replacement_restores_and_extends(smoke_model, tmp_path):
    t = mk_trainer(smoke_model, tmp_path / "a", steps=8)
    t.run()
    t.checkpoint_and_drain()
    assert t.drained
    t2 = mk_trainer(smoke_model, tmp_path / "a", steps=8)
    assert t2.admit_replacement(incarnation=1, extra_steps=3) == 8
    assert t2.incarnation == 1 and not t2.drained and not t2.draining.is_set()
    assert t2.cfg.steps == 11
    res = t2.run()
    assert res["steps_run"] == 3 and t2.step == 11
    with pytest.raises(ValueError):
        t2.admit_replacement(incarnation=-1)


def test_restore_falls_back_over_damaged_checkpoint(smoke_model, tmp_path):
    mk_trainer(smoke_model, tmp_path / "r", steps=8).run()  # step_4, step_8
    with open(tmp_path / "r" / "step_8" / "manifest.json", "w") as f:
        f.write("garbage")
    t = mk_trainer(smoke_model, tmp_path / "r", steps=8)
    t.run()
    assert t.step == 8  # resumed from step_4 and re-ran 4..8


def test_trainer_refuses_a_family_not_trained():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk_trainer(Model(get_config("mamba2-1.3b").smoke()), None)


def test_straggler_watchdog_ewma_and_api_channels():
    """Twin of ``test_cluster.py::test_straggler_watchdog_ewma_and_api_channels``."""
    from repro_torch.train import StragglerWatchdog

    w = StragglerWatchdog(factor=3.0)
    assert not w.observe_step(1.0)  # first step seeds the EWMA
    assert not w.observe_step(1.1)
    assert w.observe_step(10.0)  # > 3x EWMA
    assert w.slow_steps == 1
    w.note_api_evidence("host:1:rank2", "ust_repro", "train_step", 3.4, "test")
    reps = w.api_reports()
    assert len(reps) == 1 and reps[0].source == "host:1:rank2"
    assert reps[0].ratio == pytest.approx(3.4)
