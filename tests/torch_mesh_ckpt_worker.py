"""One rank of the port's checkpointed, elastic training checks, run by
``test_torch_mesh_checkpoint.py``.

    python tests/torch_mesh_ckpt_worker.py RANK WORK

Joins a ``gloo`` process group of four ranks over the ``FileStore`` at
``WORK/store4`` and trains the stablelm smoke model (``ShapeSpec("t",
"train", 32, 4)``, fp32) through ``Trainer``, every run starting from the
JAX trainer's step-0 checkpoint in ``WORK/init`` (made by the test):

* ``grid``: in ``tp`` and ``fsdp``, 4 steps on 2x2 with a checkpoint at
  step 4 (copied to ``WORK/port_<mode>`` for the JAX side), an
  uninterrupted 8-step run on 2x2, and the step-4 checkpoint restored onto
  2x2, 1x4, 4x1 and then, after the group is rebuilt smaller, 3x1, 2x1 and
  one rank with no group, each continued 4 steps, with each rank's restored
  blocks held against ``local_block`` of the files; the JAX 1x4 trainer's
  step-4 checkpoint restored on 2x2 and continued;
* ``fail``: 8 steps under a trace with a checkpoint every 4 and the 6th
  step call failing on every rank; then a run whose rank 1 fails after its
  7th step returned;
* ``damage``: the newest checkpoint with one leaf truncated, and a restore
  that fails on rank 3 alone;
* ``drain``: a drain requested from a second thread on rank 2 alone after
  step 3, then ``admit_replacement`` on a 1x4 trainer;
* ``bf16``: bf16 blocks saved on 2x2 and read back;
* ``fault31``: 4 steps on 4x1 from step 0.

Writes ``WORK/rank<R>.npz``.
"""

import os
import shutil
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.checkpoint import Checkpointer, list_checkpoints
from repro_torch.checkpoint.checkpointer import _tensor
from repro_torch.configs import get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model, ShapeSpec
from repro_torch.sharding import PartitionSpec, Partitioner, local_block
from repro_torch.sharding.partition import spec_items
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

STABLELM = "stablelm-3b"
SHAPE = ShapeSpec("t", "train", 32, 4)
TCFG = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
MODES = ("tp", "fsdp")
#: the meshes of four ranks a checkpoint is restored onto: name → model_parallel
MESHES4 = {"2x2": 2, "1x4": 4, "4x1": 1}
WAIT_S = 300
#: a collective that waits longer than this ends the rank (a peer has failed)
GROUP_TIMEOUT = timedelta(seconds=120)


class Flaky:
    """A step that raises on its ``fail_at``-th call, before it runs."""

    def __init__(self, step, fail_at):
        self.step, self.fail_at, self.calls = step, fail_at, 0

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("injected step failure")
        return self.step(state, batch)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def sync() -> None:
    if dist.is_initialized():
        dist.barrier()


def seeded(work: str, name: str, src: str) -> str:
    """``WORK/<name>``, holding a copy of the checkpoint ``src`` (rank 0
    copies; every rank waits for it)."""
    d = os.path.join(work, name)
    if rank() == 0:
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        shutil.copytree(src, os.path.join(d, os.path.basename(src)))
    sync()
    return d


def trainer(mesh, mode: str, ckpt_dir: str, steps: int, ckpt_every: int = 4) -> Trainer:
    part = None if mesh is None else Partitioner(mesh, mode=mode)
    model = Model(get_config(STABLELM).smoke(), mesh)
    return Trainer(model, SHAPE, "cpu", TCFG, TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
                   partitioner=part)


def losses(res) -> np.ndarray:
    return np.array([[h["step"], h["loss"]] for h in res["history"]])


def blocks_equal(t: Trainer, path: str) -> bool:
    """Each of this rank's blocks of ``t.state`` equals ``local_block`` of
    the leaf on disk under ``t``'s specs, bit for bit."""
    import json

    with open(os.path.join(path, "manifest.json")) as f:
        files = {leaf["key"]: leaf for leaf in json.load(f)["leaves"]}
    specs = dict(spec_items(t.specs))
    for key, block in tree.items(t.state):
        whole = _tensor(np.load(os.path.join(path, files[key]["file"])), files[key]["dtype"], "cpu")
        if not torch.equal(local_block(whole, specs[key], t.mesh), block):
            return False
    return True


def restored_steps(t: Trainer) -> list:
    """``t``'s restores record the step each one left the trainer at."""
    out = []
    orig = t._maybe_restore

    def restore():
        orig()
        out.append(t.step)

    t._maybe_restore = restore
    return out


def continue_from(t: Trainer, out: dict, tag: str) -> None:
    """Restore ``t`` (checking its blocks against the files), run it."""
    t._maybe_restore()
    out[f"{tag}/restored_step"] = np.array(t.step)
    out[f"{tag}/blocks_equal"] = np.array(blocks_equal(t, list_checkpoints(t.ckpt.root)[0]))
    out[f"{tag}/hist"] = losses(t.run())


def wait_for(path: str) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"no {path} after {WAIT_S} s")
        time.sleep(0.2)


def grid_cases(work: str, init: str, out: dict) -> None:
    for mode in MODES:
        t = trainer(make_local_mesh(2), mode, seeded(work, f"{mode}/run", init), 4)
        out[f"{mode}/first/hist"] = losses(t.run())
        step4 = os.path.join(t.ckpt.root, "step_4")
        out[f"{mode}/first/blocks_equal"] = np.array(blocks_equal(t, step4))
        if rank() == 0:
            shutil.copytree(step4, os.path.join(work, f"port_{mode}", "step_4"))
    if rank() == 0:
        open(os.path.join(work, "port_ready"), "w").close()
    for mode in MODES:
        t = trainer(make_local_mesh(2), mode, seeded(work, f"{mode}/full", init), 8)
        out[f"{mode}/full/hist"] = losses(t.run())
        for name, mp in MESHES4.items():
            step4 = os.path.join(work, mode, "run", "step_4")
            continue_from(trainer(make_local_mesh(mp), mode, seeded(work, f"{mode}/on{name}", step4), 8), out,
                          f"{mode}/on{name}")
    wait_for(os.path.join(work, "jax_ready"))
    for mode in MODES:
        jax4 = os.path.join(work, "jax", "ref", "step_4")
        continue_from(trainer(make_local_mesh(2), mode, seeded(work, f"{mode}/fromjax", jax4), 8), out,
                      f"{mode}/fromjax")


def fail_cases(work: str, init: str, out: dict) -> None:
    t = trainer(make_local_mesh(2), "tp", seeded(work, "fail/every", init), 8)
    t.step_fn = Flaky(t.step_fn, 6)
    steps = restored_steps(t)
    with Tracer(TraceConfig(out_dir=os.path.join(work, "trace", f"rank{rank()}"), mode="default", rank=rank())):
        res = t.run()
    out["fail/every/hist"] = losses(res)
    out["fail/every/restored"] = np.array(steps)
    out["fail/every/failures"] = np.array(res["failures"])

    t = trainer(make_local_mesh(2), "tp", seeded(work, "fail/one", init), 8)
    steps = restored_steps(t)
    one_step, calls = t._one_step, [0]

    def after_step():
        one_step()
        calls[0] += 1
        if rank() == 1 and calls[0] == 7:
            raise RuntimeError("injected failure after the step")

    t._one_step = after_step
    res = t.run()
    out["fail/one/hist"] = losses(res)
    out["fail/one/restored"] = np.array(steps)
    out["fail/one/failures"] = np.array(res["failures"])


def damage_cases(work: str, out: dict) -> None:
    root = os.path.join(work, "fail", "every")  # step_0, step_4, step_8
    if rank() == 0:
        victim = os.path.join(root, "step_8", "params__embed__tok.npy")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
    sync()
    t = trainer(make_local_mesh(2), "tp", root, 8)
    t._maybe_restore()
    out["damage/truncated/step"] = np.array(t.step)

    t = trainer(make_local_mesh(2), "tp", root, 8)
    restore = t.ckpt.restore

    def fails_on_rank3(path, *a, **k):
        if rank() == 3 and path.endswith("step_4"):
            raise ValueError("injected restore failure")
        return restore(path, *a, **k)

    t.ckpt.restore = fails_on_rank3
    t._maybe_restore()
    out["damage/rank3/step"] = np.array(t.step)


def drain_cases(work: str, init: str, out: dict) -> None:
    t = trainer(make_local_mesh(2), "tp", seeded(work, "drain", init), 8, ckpt_every=100)
    one_step = t._one_step

    def maybe_drain():
        one_step()
        if rank() == 2 and t.step == 3:
            th = threading.Thread(target=t.request_drain)
            th.start()
            th.join()

    t._one_step = maybe_drain
    res = t.run()
    out["drain/drained"] = np.array(res["drained"])
    out["drain/step"] = np.array(t.step)
    out["drain/steps_run"] = np.array(res["steps_run"])
    out["drain/newest"] = np.array(int(os.path.basename(list_checkpoints(t.ckpt.root)[0]).split("_")[1]))
    t2 = trainer(make_local_mesh(4), "tp", t.ckpt.root, 8)
    out["drain/admitted"] = np.array(t2.admit_replacement(1))
    out["drain/admitted_blocks_equal"] = np.array(blocks_equal(t2, list_checkpoints(t.ckpt.root)[0]))


def bf16_case(work: str, out: dict) -> None:
    """bf16 blocks of leaves split over both axes, one axis and none, saved
    on 2x2 through the gather (16-bit words as bytes) and restored."""
    mesh = make_local_mesh(2)
    gen = torch.Generator().manual_seed(31)
    whole = {"a": torch.randn(8, 6, generator=gen), "b": {"c": torch.randn(4, 8, generator=gen)},
             "n": torch.randn(5, generator=gen)}
    whole = tree.map(lambda t: t.to(torch.bfloat16), whole)
    specs = {"a": PartitionSpec("data", "model"), "b": {"c": PartitionSpec(None, "model")}, "n": PartitionSpec()}
    blocks = {"a": local_block(whole["a"], specs["a"], mesh).clone(),
              "b": {"c": local_block(whole["b"]["c"], specs["b"]["c"], mesh).clone()}, "n": whole["n"].clone()}
    ck = Checkpointer(os.path.join(work, "bf16"), mesh=mesh)
    path = ck.save(1, blocks, specs=specs)
    ok = True
    if rank() == 0:
        for key, w in tree.items(whole):
            words = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
            ok &= words.dtype == np.uint16 and np.array_equal(words.view(np.int16), w.view(torch.int16).numpy())
    back, _ = ck.restore(path, blocks, specs=specs, mesh=mesh)
    ok &= all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(tree.leaves(back), tree.leaves(blocks)))
    out["bf16/equal"] = np.array(ok)


def smaller_groups(r: int, work: str, out: dict) -> None:
    """The step-4 checkpoints restored on 3x1 (ranks 0-2), 2x1 (ranks 0-1)
    and one rank with no group (rank 0)."""
    for world in (3, 2):
        if r >= world:
            return
        dist.init_process_group("gloo", init_method=f"file://{work}/store{world}", rank=r, world_size=world,
                                timeout=GROUP_TIMEOUT)
        for mode in MODES:
            step4 = os.path.join(work, mode, "run", "step_4")
            continue_from(trainer(make_local_mesh(1), mode, seeded(work, f"{mode}/on{world}x1", step4), 8), out,
                          f"{mode}/on{world}x1")
        dist.barrier()
        dist.destroy_process_group()
    if r == 0:
        for mode in MODES:
            step4 = os.path.join(work, mode, "run", "step_4")
            continue_from(trainer(None, mode, seeded(work, f"{mode}/on1", step4), 8), out, f"{mode}/on1")


def main(argv) -> int:
    r, work = int(argv[0]), argv[1]
    init = os.path.join(work, "init", "step_0")
    dist.init_process_group("gloo", init_method=f"file://{work}/store4", rank=r, world_size=4, timeout=GROUP_TIMEOUT)
    torch.manual_seed(0)
    out: dict = {}
    grid_cases(work, init, out)
    fail_cases(work, init, out)
    damage_cases(work, out)
    drain_cases(work, init, out)
    bf16_case(work, out)
    t = trainer(make_local_mesh(1), "tp", seeded(work, "fault31", init), 4)
    out["fault31/4x1/hist"] = losses(t.run())
    dist.barrier()
    dist.destroy_process_group()
    smaller_groups(r, work, out)
    np.savez(os.path.join(work, f"rank{r}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
