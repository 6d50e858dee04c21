"""Quickstart: train a small model for a few steps UNDER THAPI TRACING, then
analyse the trace with the tally and validation plugins.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a card it raises.
The model is the smoke width of h2o-danube-1.8b, as in the JAX example.
"""

import argparse
import sys
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import render, tally_trace
from repro_torch.core.plugins.validate import render as vrender, validate_trace
from repro_torch.models import Model, ShapeSpec
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    model = Model(get_config("h2o-danube-1.8b").smoke())
    trace_dir = tempfile.mkdtemp(prefix="thapi_quickstart_torch_")

    with Tracer(TraceConfig(out_dir=trace_dir, mode="default", sample=True)):
        trainer = Trainer(
            model,
            ShapeSpec("quickstart", "train", 64, 4),
            device,
            TrainConfig(peak_lr=3e-3, warmup=5, total_steps=100),
            TrainerConfig(steps=args.steps, ckpt_every=10, ckpt_dir=trace_dir + "/ckpt"),
        )
        result = trainer.run()

    print(f"trained {result['steps_run']} steps, final loss {result['final_loss']:.3f}\n")
    t = tally_trace(trace_dir)
    print(render(t))
    print("\n-- device --")
    print(render(t, device=True))
    print()
    print(vrender(validate_trace(trace_dir)))
    print(f"\ntrace at {trace_dir} — try:")
    print(f"  PYTHONPATH=src python -m repro_torch.core.iprof timeline {trace_dir} -o tl.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
