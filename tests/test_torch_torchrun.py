"""PyTorch port: the training launcher and the ``distributed_train``
example's default mode started by ``torchrun`` (``python -m
torch.distributed.run --standalone``) on the CPU, their ranks joined over
``gloo``, and started without it, on one rank as before.

The launcher trains stablelm smoke on 2 ranks with checkpoints in a shared
directory, then a start on 4 ranks restores its step-4 checkpoint onto the
4x1 mesh and runs the 2 steps left.  The example trains danube-100m on 2
ranks (at 2 x 16 tokens a step, to keep the CPU run short).  Each command
runs with its own time limit.
"""

import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

from repro_torch.examples import distributed_train
from repro_torch.launch import train as train_launcher

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 300


def torchrun(ranks: int, module: str, *args: str, tmp) -> str:
    """``module``'s standard output from ``ranks`` ranks; fails on a
    non-zero exit."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                           str(ranks), "-m", module, *args], env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}"
    return proc.stdout


def test_launcher_trains_over_ranks_and_restarts_on_another_rank_count(tmp_path):
    ck, tr = str(tmp_path / "ck"), str(tmp_path / "tr")
    out = torchrun(2, "repro_torch.launch.train", "--device", "cpu", "--arch", "stablelm-3b", "--steps", "4",
                   "--ckpt-dir", ck, "--trace", "default", "--trace-dir", tr, tmp=tmp_path)
    assert len(re.findall(r"^stablelm-3b: loss ", out, re.M)) == 1, out  # rank 0 alone prints
    assert "in 4 steps on cpu" in out and "mesh data=2xmodel=1" in out
    assert "train_step" in out and "checkpoint_save" in out
    assert sorted(os.listdir(ck)) == ["step_2", "step_4"]
    assert sorted(os.listdir(tr)) == ["rank0", "rank1"]
    out = torchrun(4, "repro_torch.launch.train", "--device", "cpu", "--arch", "stablelm-3b", "--steps", "6",
                   "--ckpt-dir", ck, tmp=tmp_path)
    assert "in 2 steps on cpu" in out and "mesh data=4xmodel=1" in out, out
    assert "step_6" in os.listdir(ck)


def test_example_default_mode_trains_over_ranks(tmp_path):
    out = torchrun(2, "repro_torch.examples.distributed_train", "--device", "cpu", "--steps", "6", "--seq", "16",
                   "--batch", "2", tmp=tmp_path)
    assert "mesh data=2xmodel=1" in out
    assert re.search(r"^loss: [0-9.]+ → [0-9.]+ over 6 steps", out, re.M), out
    assert "train_step" in out and "validation: clean" in out
    assert "OK: the traces of all 2 ranks validate without errors" in out


def test_without_torchrun_the_launcher_and_the_example_train_on_one_rank(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train_launcher.main(["--arch", "stablelm-3b", "--device", "cpu", "--steps", "2", "--trace", "default",
                                  "--trace-dir", str(tmp_path / "tr")])
    assert rc == 0 and "mesh data=1xmodel=1" in buf.getvalue()
    assert "metadata.json" in os.listdir(tmp_path / "tr")  # no rank<R> directories
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = distributed_train.main(["--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "1"])
    out = buf.getvalue()
    assert rc == 0 and "mesh data=1xmodel=1" in out and "validation: clean" in out
    assert "OK: the traces" not in out
