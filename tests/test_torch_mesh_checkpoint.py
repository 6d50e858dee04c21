"""PyTorch port, checkpointed and elastic training over a mesh of ``gloo``
ranks, against the JAX trainer on four fake XLA host devices.

One module fixture writes the JAX trainer's step-0 state (``init_state``
from ``PRNGKey(0)``, the stablelm smoke model, fp32) as a checkpoint with
the JAX checkpointer, then runs at once the JAX side in a subprocess
(``tests/torch_mesh_ckpt_jax.py``) and the port's four ranks
(``tests/torch_mesh_ckpt_worker.py``, a ``FileStore`` under ``tmp_path``),
each process with its own time limit.  Every trainer of both packages
restores that step-0 checkpoint first, and both pipelines give the same
batches, so the losses compare step for step.

Tolerances: losses within 1e-4 (fp32, smoke width) of the port's
uninterrupted 2x2 run and of the JAX 1x4 trainer's, on every mesh the
step-4 checkpoint is restored onto (2x2, 1x4, 4x1, 3x1, 2x1, one rank) and
across the packages' checkpoints; restored blocks and bf16 leaves bit for
bit; replayed losses equal to the first attempt's.  The JAX trainer on a
mesh whose data axis has more than one device trains on ``global_batch /
dp`` rows as if they were the batch (ROADMAP fault 31); the port does not.
"""

import json
import os
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.data import SyntheticPipeline as JaxPipeline
from repro.jaxcompat import make_mesh
from repro.models import Model as JaxModel
from repro.models import ShapeSpec as JaxShapeSpec
from repro.train import TrainConfig as JaxTrainConfig
from repro.train.train_step import init_state as jax_init_state

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_ckpt_worker.py")
JAX_SIDE = os.path.join(ROOT, "tests", "torch_mesh_ckpt_jax.py")
TIMEOUT_S = 400
TOL = 1e-4
MODES = ("tp", "fsdp")
#: mesh the step-4 checkpoint is restored onto → the ranks that run it
RESTORES = {"2x2": 4, "1x4": 4, "4x1": 4, "3x1": 3, "2x1": 2, "1": 1}
FRAMEWORK_APIS = ("train_step", "data_next", "optimizer_update", "checkpoint_save", "checkpoint_restore")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work directory, JAX outputs, the port's outputs by rank)."""
    work = tmp_path_factory.mktemp("meshckpt")
    jm = JaxModel(jax_get_config("stablelm-3b").smoke(), make_mesh((1, 1), ("data", "model")))
    state = jax_init_state(jm, JaxTrainConfig(peak_lr=5e-3, warmup=2, total_steps=100), jax.random.PRNGKey(0))
    pipe = JaxPipeline(jm, JaxShapeSpec("t", "train", 32, 4))
    JaxCheckpointer(str(work / "init")).save(0, state, extra={"data": pipe.state_dict()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {"jax": subprocess.Popen([sys.executable, JAX_SIDE, str(work)], env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)}
    for r in range(4):
        procs[r] = subprocess.Popen([sys.executable, WORKER, str(r), str(work)], env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
    failed = []
    for name, p in procs.items():
        try:
            so, se = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} ran past {TIMEOUT_S} s")
        if p.returncode != 0:
            failed.append(f"{name} exit {p.returncode}\n{so[-2000:]}\n{se[-4000:]}")
    assert not failed, "\n".join(failed)
    ranks = {r: dict(np.load(str(work / f"rank{r}.npz"))) for r in range(4)}
    return work, dict(np.load(str(work / "jax.npz"))), ranks


def steps_and_losses(hist: np.ndarray):
    return hist[:, 0].astype(int).tolist(), hist[:, 1]


def close(hist: np.ndarray, want: np.ndarray) -> None:
    """Same steps, losses within TOL."""
    assert steps_and_losses(hist)[0] == steps_and_losses(want)[0]
    assert np.max(np.abs(hist[:, 1] - want[:, 1])) <= TOL, (hist, want)


def replays_equal(hist: np.ndarray) -> None:
    """Each step that ran more than once had the same loss every time."""
    first = {}
    for step, loss in hist:
        assert first.setdefault(int(step), loss) == loss, (step, hist)


@pytest.mark.parametrize("mode", MODES)
def test_the_2x2_trainer_tracks_the_jax_1x4_trainer(runs, mode):
    _, jax_out, ranks = runs
    for out in ranks.values():
        close(out[f"{mode}/first/hist"], jax_out["ref"][:4])
        close(out[f"{mode}/full/hist"], jax_out["ref"])


@pytest.mark.parametrize("mesh", list(RESTORES))
@pytest.mark.parametrize("mode", MODES)
def test_a_2x2_checkpoint_continues_on_any_mesh(runs, mode, mesh):
    """The step-4 checkpoint of the 2x2 run, restored onto ``mesh``, gives
    the uninterrupted 2x2 run's losses for steps 5-8, and the JAX 1x4
    trainer's."""
    _, jax_out, ranks = runs
    for r in range(RESTORES[mesh]):
        out = ranks[r]
        assert int(out[f"{mode}/on{mesh}/restored_step"]) == 4
        close(out[f"{mode}/on{mesh}/hist"], out[f"{mode}/full/hist"][4:])
        close(out[f"{mode}/on{mesh}/hist"], jax_out["ref"][4:])


@pytest.mark.parametrize("mesh", ["saved"] + list(RESTORES))
@pytest.mark.parametrize("mode", MODES)
def test_each_rank_holds_local_block_of_the_files(runs, mode, mesh):
    """Bit for bit: after the save, each rank's blocks are its blocks of the
    leaves on disk (the gather placed every block); after a restore onto
    ``mesh``, each rank's blocks are ``local_block`` of the leaves under
    that mesh's specs."""
    _, _, ranks = runs
    key = f"{mode}/first/blocks_equal" if mesh == "saved" else f"{mode}/on{mesh}/blocks_equal"
    for r in range(4 if mesh == "saved" else RESTORES[mesh]):
        assert bool(ranks[r][key])


@pytest.mark.parametrize("mode", MODES)
def test_a_2x2_checkpoint_is_a_one_device_checkpoint(runs, mode):
    """The same keys, whole shapes and dtypes as the JAX 1x4 trainer's
    step-4 checkpoint (whole host arrays), and every file's CRC is the
    manifest's."""
    work, _, _ = runs

    def manifest(path):
        with open(os.path.join(path, "manifest.json")) as f:
            return {leaf["key"]: leaf for leaf in json.load(f)["leaves"]}

    port_dir, jax_dir = str(work / f"port_{mode}" / "step_4"), str(work / "jax" / "ref" / "step_4")
    port, ref = manifest(port_dir), manifest(jax_dir)
    assert sorted(port) == sorted(ref)
    for key, leaf in port.items():
        assert (leaf["shape"], leaf["dtype"], leaf["nbytes"]) == (ref[key]["shape"], ref[key]["dtype"],
                                                                  ref[key]["nbytes"]), key
        arr = np.load(os.path.join(port_dir, leaf["file"]))
        assert zlib.crc32(arr.tobytes()) == leaf["crc32"], key


@pytest.mark.parametrize("mode", MODES)
def test_the_jax_trainer_continues_a_port_2x2_checkpoint_on_1x4(runs, mode):
    _, jax_out, ranks = runs
    close(jax_out[f"from/{mode}"], ranks[0][f"{mode}/full/hist"][4:])


@pytest.mark.parametrize("mode", MODES)
def test_the_port_continues_a_jax_1x4_checkpoint_on_2x2(runs, mode):
    _, jax_out, ranks = runs
    for out in ranks.values():
        assert int(out[f"{mode}/fromjax/restored_step"]) == 4 and bool(out[f"{mode}/fromjax/blocks_equal"])
        close(out[f"{mode}/fromjax/hist"], jax_out["ref"][4:])


def test_a_failure_on_every_rank_restores_and_replays_on_every_rank(runs):
    """The 6th step call fails on every rank: each restores step 4 (after
    the first restore, of step 0, at the start), replays step 5 with the
    same loss, and the run matches the JAX trainer with the same failure."""
    _, jax_out, ranks = runs
    for out in ranks.values():
        assert out["fail/every/restored"].tolist() == [0, 4]
        assert int(out["fail/every/failures"]) == 1
        replays_equal(out["fail/every/hist"])
        close(out["fail/every/hist"], jax_out["fail/hist"])
        np.testing.assert_array_equal(out["fail/every/hist"], ranks[0]["fail/every/hist"])


def test_a_failure_on_one_rank_after_its_step_restores_every_rank(runs):
    """Rank 1 raises after its 7th step returned: every rank restores step
    4 and replays steps 5-7 with the first attempts' losses."""
    _, _, ranks = runs
    for out in ranks.values():
        assert out["fail/one/restored"].tolist() == [0, 4]
        assert int(out["fail/one/failures"]) == 1
        steps, _ = steps_and_losses(out["fail/one/hist"])
        assert steps == [1, 2, 3, 4, 5, 6, 7, 5, 6, 7, 8]
        replays_equal(out["fail/one/hist"])
        np.testing.assert_array_equal(out["fail/one/hist"], ranks[0]["fail/one/hist"])


def test_a_damaged_checkpoint_sends_every_rank_to_the_same_older_one(runs):
    """A truncated leaf in step 8: every rank restores step 4.  A restore
    of step 4 that fails on rank 3 alone: every rank restores step 0."""
    _, _, ranks = runs
    for out in ranks.values():
        assert int(out["damage/truncated/step"]) == 4
        assert int(out["damage/rank3/step"]) == 0


def test_a_drain_requested_on_one_rank_drains_every_rank_at_one_step(runs):
    """Rank 2 alone asks to drain after step 3, from a second thread: every
    rank drains at step 3, and a new 1x4 trainer admits the replacement
    from that checkpoint."""
    _, _, ranks = runs
    for out in ranks.values():
        assert bool(out["drain/drained"])
        assert int(out["drain/step"]) == int(out["drain/steps_run"]) == int(out["drain/newest"]) == 3
        assert int(out["drain/admitted"]) == 3 and bool(out["drain/admitted_blocks_equal"])


def test_bf16_blocks_are_saved_whole_and_restored_bit_for_bit(runs):
    _, _, ranks = runs
    for out in ranks.values():
        assert bool(out["bf16/equal"])


def test_rank0_trace_has_the_jax_trainers_framework_rows(runs):
    """Under the JAX package's tally: each framework API's count on rank 0
    equals the JAX trainer's run with the same failure (10 train steps, 3
    saves, 2 restores: step 0 at the start, step 4 after the failure)."""
    work, _, _ = runs

    def rows(trace_dir):
        t = jax_tally_trace(trace_dir)
        return {api: t.apis[("ust_repro", api)].calls if ("ust_repro", api) in t.apis else 0
                for api in FRAMEWORK_APIS}

    got, want = rows(str(work / "trace" / "rank0")), rows(str(work / "jax" / "trace"))
    assert got == want
    assert got["train_step"] == 10 and got["checkpoint_save"] == 3 and got["checkpoint_restore"] == 2


def test_fault31_the_jax_trainer_trains_a_replica_batch_on_a_data_axis(runs):
    """ROADMAP fault 31: the JAX trainer on 1x1 and 1x4 trains the same
    losses; on 2x2 it trains ``global_batch / 2`` rows (its first loss is
    another); on 4x1 with a global batch of 4 its ``device_put`` of the one
    row it was given raises."""
    _, jax_out, _ = runs
    close(jax_out["fault31/1x1"], jax_out["ref"][:4])
    assert abs(jax_out["fault31/2x2"][0, 1] - jax_out["ref"][0, 1]) > 1e-3
    assert "divisible" in str(jax_out["fault31/4x1/error"])


def test_fault31_the_port_trains_the_whole_batch_on_every_mesh(runs):
    _, jax_out, ranks = runs
    for out in ranks.values():
        close(out["tp/first/hist"], jax_out["ref"][:4])
        close(out["fault31/4x1/hist"], jax_out["ref"][:4])
