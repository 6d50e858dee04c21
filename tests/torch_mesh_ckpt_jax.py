"""The JAX side of ``test_torch_mesh_checkpoint.py``, on four fake XLA host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``test_multidevice.py`` sets it).

    python tests/torch_mesh_ckpt_jax.py WORK

Every ``Trainer`` (stablelm smoke, ``ShapeSpec("t", "train", 32, 4)``,
fp32) starts from the step-0 checkpoint in ``WORK/init``: 8 steps on 1x4
with a checkpoint every 4 (``WORK/jax_ready`` marks its step-4 checkpoint
for the port); 4 steps on 1x1 and on 2x2, and 4x1's error (ROADMAP fault
31); 8 steps on 1x4 under a trace with the 6th step call failing; then,
once the port has written them, the port's 2x2 step-4 checkpoints restored
on 1x4 and continued 4 steps.  Writes ``WORK/jax.npz``.
"""

import os
import shutil
import sys
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import TraceConfig, Tracer  # noqa: E402
from repro.jaxcompat import device_mesh  # noqa: E402
from repro.models import Model, ShapeSpec  # noqa: E402
from repro.sharding import Partitioner  # noqa: E402
from repro.train import TrainConfig, Trainer, TrainerConfig  # noqa: E402

SHAPE = ShapeSpec("t", "train", 32, 4)
TCFG = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
WAIT_S = 300


class Flaky:
    def __init__(self, step, fail_at):
        self.step, self.fail_at, self.calls = step, fail_at, 0

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("injected step failure")
        return self.step(state, batch)


def trainer(data: int, model: int, ckpt_dir: str, steps: int) -> Trainer:
    mesh = device_mesh(np.array(jax.devices()[: data * model]).reshape(data, model), ("data", "model"))
    return Trainer(Model(get_config("stablelm-3b").smoke(), mesh), SHAPE, Partitioner(mesh), TCFG,
                   TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=ckpt_dir))


def seeded(work: str, name: str, src: str) -> str:
    d = os.path.join(work, "jax", name)
    os.makedirs(d)
    shutil.copytree(src, os.path.join(d, os.path.basename(src)))
    return d


def losses(res) -> np.ndarray:
    return np.array([[h["step"], h["loss"]] for h in res["history"]])


def main(work: str) -> int:
    init = os.path.join(work, "init", "step_0")
    out = {"ref": losses(trainer(1, 4, seeded(work, "ref", init), 8).run())}
    open(os.path.join(work, "jax_ready"), "w").close()
    for d, m in ((1, 1), (2, 2)):
        out[f"fault31/{d}x{m}"] = losses(trainer(d, m, seeded(work, f"f31_{d}x{m}", init), 4).run())
    try:
        trainer(4, 1, seeded(work, "f31_4x1", init), 4).run()
        out["fault31/4x1/error"] = np.array("")
    except ValueError as e:
        out["fault31/4x1/error"] = np.array(str(e))
    t = trainer(1, 4, seeded(work, "fail", init), 8)
    t.step_fn = Flaky(t.step_fn, 6)
    with Tracer(TraceConfig(out_dir=os.path.join(work, "jax", "trace"), mode="default")):
        out["fail/hist"] = losses(t.run())
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(work, "port_ready")):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError("the port wrote no step-4 checkpoint")
        time.sleep(0.2)
    for mode in ("tp", "fsdp"):
        step4 = os.path.join(work, f"port_{mode}", "step_4")
        out[f"from/{mode}"] = losses(trainer(1, 4, seeded(work, f"from_{mode}", step4), 8).run())
    np.savez(os.path.join(work, "jax.npz"), **out)
    print("JAX_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
