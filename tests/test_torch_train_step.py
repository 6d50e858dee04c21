"""PyTorch port, the train step, the traced trainer and the launcher against
the JAX package.

Both packages start from one state (the JAX ``init_state``, carried across
with ``convert.state_from_jax``) and take the same batches (their pipelines
agree byte for byte, ``test_torch_train.py``).  Tolerances: each step's
``loss`` and ``grad_norm`` relative 1e-4 against JAX's
``build_train_artifacts`` step (readings: loss up to 2.0e-7, grad_norm up
to 4.0e-7, 2.7e-6 with the int8 compression); the parameters after the
steps 1e-4 of each leaf's largest value (readings up to 1.1e-5);
microbatches=2 against the full batch, loss 1e-5 relative and the updated
weights within the JAX test's 1e-3 / 1e-5.  A traced training run's framework rows are counted
under the JAX package's ``tally_trace``, and must equal the JAX trainer's.
"""

import dataclasses
import functools
import io
import os
import re
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.data import SyntheticPipeline as JaxPipeline
from repro.jaxcompat import make_mesh
from repro.models import Model as JaxModel
from repro.models import ShapeSpec as JaxShapeSpec
from repro.sharding import Partitioner
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train.train_step import build_train_artifacts, init_state as jax_init_state
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.interception import nbytes_of
from repro_torch.data import SyntheticPipeline
from repro_torch.examples import quickstart
from repro_torch.launch import train as train_launcher
from repro_torch.models import Model, ShapeSpec
from repro_torch.train import TrainConfig, Trainer, TrainerConfig, build_train_step, init_state

STEP_TOL = 1e-4  # relative, per step's loss and grad_norm
DANUBE = "h2o-danube-1.8b"
SHAPE, JSHAPE = ShapeSpec("t", "train", 32, 4), JaxShapeSpec("t", "train", 32, 4)
FRAMEWORK_APIS = ("train_step", "data_next", "optimizer_update", "checkpoint_save", "checkpoint_restore")


@functools.lru_cache(maxsize=None)
def jax_run(arch, microbatches=1, grad_compression=False, steps=5):
    """The JAX step's (loss, grad_norm) per step, its initial state as numpy
    and its final parameters, from ``PRNGKey(0)``."""
    jm = JaxModel(jax_get_config(arch).smoke(), make_mesh((1, 1), ("data", "model")))
    tcfg = JaxTrainConfig(peak_lr=5e-3, warmup=2, total_steps=100, microbatches=microbatches,
                          grad_compression=grad_compression)
    step, *_ = build_train_artifacts(jm, Partitioner(jm.mesh), JSHAPE, tcfg)
    state = jax_init_state(jm, tcfg, jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.array, state)
    pipe = JaxPipeline(jm, JSHAPE)
    out = []
    for _ in range(steps):
        state, m = step(state, {k: jax.numpy.asarray(v) for k, v in next(pipe).items()})
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    return out, init, jax.tree_util.tree_map(np.asarray, state["params"])


def port_run(arch, microbatches=1, grad_compression=False, steps=5):
    tm = Model(get_config(arch).smoke())
    tcfg = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100, microbatches=microbatches,
                       grad_compression=grad_compression)
    step = build_train_step(tm, SHAPE, tcfg, "cpu")
    state = state_from_jax(jax_run(arch, microbatches, grad_compression, steps)[1], "cpu")
    pipe = SyntheticPipeline(tm, SHAPE)
    out = []
    for _ in range(steps):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in next(pipe).items()})
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    return out, state


@pytest.mark.parametrize(
    "arch,microbatches,grad_compression",
    [(DANUBE, 1, False), (DANUBE, 2, False), (DANUBE, 1, True), ("llava-next-34b", 1, False),
     ("moonshot-v1-16b-a3b", 1, False), ("whisper-medium", 1, False)],
)
def test_five_steps_match_the_jax_step(arch, microbatches, grad_compression):
    """With ``grad_compression`` the weights are not compared: a gradient
    ~1e-7 apart can round to the next int8 step, one quantum apart."""
    want, _, want_params = jax_run(arch, microbatches, grad_compression)
    got, state = port_run(arch, microbatches, grad_compression)
    for i, ((gl, gn, glr), (wl, wn, wlr)) in enumerate(zip(got, want, strict=True)):
        assert abs(gl - wl) <= STEP_TOL * abs(wl), (i, gl, wl)
        assert abs(gn - wn) <= STEP_TOL * abs(wn), (i, gn, wn)
        assert glr == pytest.approx(wlr, rel=1e-6)
    assert got[-1][0] < got[0][0]
    got_params = dict(tree.items(state["params"]))
    for key, w in tree.items(want_params) if not grad_compression else ():
        assert np.abs(got_params[key].numpy() - w).max() <= 1e-4 * np.abs(w).max(), key
    assert int(state["opt"]["count"]) == 5


def test_bf16_training_tracks_the_jax_step():
    """The smoke danube in bf16 (weights and activations; fp32 moments), 6
    steps from one state: the rounding points are the JAX package's, so
    the loss stays within 2e-4 and the gradient norm within 2e-3 relative
    (readings 7.0e-5 and 9.8e-4)."""
    jm = JaxModel(dataclasses.replace(jax_get_config(DANUBE).smoke(), dtype="bfloat16"),
                  make_mesh((1, 1), ("data", "model")))
    tm = Model(dataclasses.replace(get_config(DANUBE).smoke(), dtype="bfloat16"))
    jcfg, tcfg = JaxTrainConfig(peak_lr=5e-3, warmup=2, total_steps=100), TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
    jstep, *_ = build_train_artifacts(jm, Partitioner(jm.mesh), JSHAPE, jcfg)
    jstate = jax_init_state(jm, jcfg, jax.random.PRNGKey(0))
    state = state_from_jax(jax.tree_util.tree_map(np.array, jstate), "cpu")
    assert state["params"]["embed"]["tok"].dtype == torch.bfloat16
    step = build_train_step(tm, SHAPE, tcfg, "cpu")
    jpipe, pipe = JaxPipeline(jm, JSHAPE), SyntheticPipeline(tm, SHAPE)
    for i in range(6):
        jstate, jm_ = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in next(jpipe).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in next(pipe).items()})
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), rel=2e-4), i
        assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]), rel=2e-3), i


def test_bf16_whisper_tracks_the_jax_step_on_frames_in_the_model_dtype():
    """The smoke whisper in bf16, 6 steps from one state.  The pipelines draw
    fp32 frames; ``batch_specs`` declares them in the model's dtype.  The
    port casts them to it; the JAX step cannot take them in fp32 (its
    decoder scan's carry turns fp32 after the first cross attention), so
    it is fed them cast to bf16, and the two then track as danube's bf16
    steps do: loss within 2e-4, gradient norm within 2e-3 (readings 7.8e-5
    and 9.7e-4; ROADMAP fault 28)."""
    arch = "whisper-medium"
    jm = JaxModel(dataclasses.replace(jax_get_config(arch).smoke(), dtype="bfloat16"),
                  make_mesh((1, 1), ("data", "model")))
    tm = Model(dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16"))
    jcfg, tcfg = JaxTrainConfig(peak_lr=5e-3, warmup=2, total_steps=100), TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
    jstep, *_ = build_train_artifacts(jm, Partitioner(jm.mesh), JSHAPE, jcfg)
    jstate = jax_init_state(jm, jcfg, jax.random.PRNGKey(0))
    state = state_from_jax(jax.tree_util.tree_map(np.array, jstate), "cpu")
    step = build_train_step(tm, SHAPE, tcfg, "cpu")
    jpipe, pipe = JaxPipeline(jm, JSHAPE), SyntheticPipeline(tm, SHAPE)
    first = next(JaxPipeline(jm, JSHAPE))
    assert first["frames"].dtype == np.float32
    with pytest.raises(TypeError, match="carry"):
        jstep(jax.tree_util.tree_map(jax.numpy.copy, jstate), {k: jax.numpy.asarray(v) for k, v in first.items()})
    for i in range(6):
        jb = next(jpipe)
        jb["frames"] = jb["frames"].astype(jax.numpy.bfloat16)
        jstate, jm_ = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in jb.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in next(pipe).items()})
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), rel=2e-4), i
        assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]), rel=2e-3), i


def test_microbatch_accumulation_matches_full_batch():
    """The twin of the JAX test: grad accumulation over 2 microbatches is one
    full-batch step."""
    tm = Model(get_config("stablelm-3b").smoke())
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticPipeline(tm, SHAPE)).items()}
    out = {}
    for k in (1, 2):
        tcfg = TrainConfig(peak_lr=1e-3, warmup=0, total_steps=10, microbatches=k)
        state = init_state(tm, tcfg, torch.Generator().manual_seed(0))
        out[k] = build_train_step(tm, SHAPE, tcfg, "cpu")(state, batch)
    (sf, mf), (sm, mm) = out[1], out[2]
    assert float(mf["loss"]) == pytest.approx(float(mm["loss"]), rel=1e-5)
    np.testing.assert_allclose(tree.leaves(sf["params"])[0].numpy(), tree.leaves(sm["params"])[0].numpy(),
                               rtol=1e-3, atol=1e-5)


def test_step_updates_the_state_in_place_and_records_its_sizes(tmp_path):
    """The state is donated: the step writes into it and returns it.  Its
    dispatch row carries the state's bytes as donated, and its launch row
    the model's FLOPs for the step's tokens."""
    tm = Model(get_config(DANUBE).smoke())
    tcfg = TrainConfig()
    state = init_state(tm, tcfg, torch.Generator().manual_seed(0))
    ptrs = [t.data_ptr() for t in tree.leaves(state)]
    step = build_train_step(tm, SHAPE, tcfg, "cpu")
    assert step.name == f"train_step[{tm.cfg.name}/t]"
    assert step.flops == tm.model_flops_per_token() * SHAPE.tokens * 3
    assert step.bytes_accessed == nbytes_of(state)
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticPipeline(tm, SHAPE)).items()}
    with Tracer(TraceConfig(out_dir=str(tmp_path), mode="default")):
        new, m = step(state, batch)
    assert new is state and [t.data_ptr() for t in tree.leaves(new)] == ptrs
    assert not any(t.requires_grad for t in tree.leaves(new))
    t = jax_tally_trace(str(tmp_path))
    assert t.apis[("ust_torchrt", "dispatch")].calls == 1
    assert t.device_apis[("ust_kernel", step.name)].calls == 1


# ---------------------------------------------------------------------------
# Traced trainer against the JAX trainer
# ---------------------------------------------------------------------------


class Flaky:
    """A step that raises once, on its ``fail_at``-th call."""

    def __init__(self, step, fail_at):
        self.step, self.fail_at, self.calls = step, fail_at, 0

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("injected node failure")
        return self.step(state, batch)


def _framework_rows(trace_dir):
    t = jax_tally_trace(trace_dir)
    return {api: t.apis[("ust_repro", api)].calls if ("ust_repro", api) in t.apis else 0 for api in FRAMEWORK_APIS}


def test_traced_training_tallies_as_the_jax_trainer(tmp_path):
    """8 steps, a checkpoint every 4, one failure on the 6th step call: the
    restore-and-replay shows as rows; each framework API's count equals the
    JAX trainer's run with the same config."""
    cfg = dict(steps=8, ckpt_every=4)
    jm = JaxModel(jax_get_config(DANUBE).smoke(), make_mesh((1, 1), ("data", "model")))
    jt = JaxTrainer(jm, JSHAPE, Partitioner(jm.mesh), JaxTrainConfig(peak_lr=5e-3, warmup=2, total_steps=100),
                    JaxTrainerConfig(ckpt_dir=str(tmp_path / "jck"), **cfg))
    jt.step_fn = Flaky(jt.step_fn, 6)
    with JaxTracer(JaxTraceConfig(out_dir=str(tmp_path / "jtr"), mode="default")):
        jres = jt.run()
    tt = Trainer(Model(get_config(DANUBE).smoke()), SHAPE, "cpu", TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100),
                 TrainerConfig(ckpt_dir=str(tmp_path / "tck"), **cfg))
    tt.step_fn = Flaky(tt.step_fn, 6)
    with Tracer(TraceConfig(out_dir=str(tmp_path / "ttr"), mode="default")):
        tres = tt.run()
    assert tres["failures"] == jres["failures"] == 1
    assert tres["steps_run"] == jres["steps_run"]
    want, got = _framework_rows(str(tmp_path / "jtr")), _framework_rows(str(tmp_path / "ttr"))
    assert got == want
    # 5 steps, the failed 6th (its row exits with status 1), 4 replayed from
    # step 4; saves at steps 4 and 8 and the final one; one restore
    assert got["train_step"] == 10 and got["checkpoint_restore"] == 1 and got["checkpoint_save"] == 3
    assert all(np.isfinite(h["loss"]) for h in tres["history"])


# ---------------------------------------------------------------------------
# Launcher, quickstart, the iprof target
# ---------------------------------------------------------------------------


def test_launcher_trains_on_the_cpu_when_asked(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train_launcher.main(["--arch", DANUBE, "--smoke", "--device", "cpu", "--steps", "4", "--seq", "16",
                                  "--trace", "default", "--trace-dir", str(tmp_path / "tr"),
                                  "--ckpt-dir", str(tmp_path / "ck")])
    out = buf.getvalue()
    assert rc == 0
    assert f"{DANUBE}: loss " in out and "in 4 steps" in out
    assert "train_step" in out and "data_next" in out
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]


def test_launcher_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launcher.main(["--arch", DANUBE])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_launcher_exits_non_zero_for_a_family_not_trained(arch, capsys):
    assert train_launcher.main(["--arch", arch, "--device", "cpu"]) == 2
    assert "ROADMAP section 4" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "whisper-medium"])
def test_launcher_trains_the_moe_and_audio_families_on_the_cpu(arch, tmp_path):
    """The smoke model, 8 steps of 4 x 16 tokens (whisper's over the
    pipeline's random frames) under a trace: the loss falls."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train_launcher.main(["--arch", arch, "--device", "cpu", "--steps", "8", "--seq", "16",
                                  "--trace", "default", "--trace-dir", str(tmp_path / "tr")])
    out = buf.getvalue()
    assert rc == 0, out
    m = re.search(rf"^{arch}: loss ([0-9.]+) → ([0-9.]+) in 8 steps on cpu", out, re.M)
    assert m is not None, out
    assert float(m.group(2)) < float(m.group(1))
    assert "train_step" in out and "data_next" in out


def test_quickstart_trains_and_tallies_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert quickstart.main(["--device", "cpu", "--steps", "4"]) == 0
    out = buf.getvalue()
    assert "trained 4 steps" in out and "train_step" in out


def test_iprof_target_twin_records_three_train_steps(tmp_path):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        import torch_iprof_target
    finally:
        sys.path.pop(0)
    with Tracer(TraceConfig(out_dir=str(tmp_path), mode="default")):
        torch_iprof_target.main()
    t = jax_tally_trace(str(tmp_path))
    assert t.apis[("ust_repro", "train_step")].calls == 3
    assert t.device_apis[("ust_kernel", "square_sum")].calls == 3


def test_train_config_mirrors_jax():
    assert {f.name for f in dataclasses.fields(TrainConfig)} == {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert {f.name for f in dataclasses.fields(TrainerConfig)} == {f.name for f in dataclasses.fields(JaxTrainerConfig)}
