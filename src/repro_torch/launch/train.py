"""Training launcher: ``--arch <id>`` selects a configuration.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --steps 20 --trace default --sample
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --full --seq 1024 --batch 4 --steps 8 --trace default

Runs on CUDA unless ``--device cpu`` is given; without a card it raises
rather than fall back.  The default is the ``.smoke()`` reduction (the JAX
launcher's ``--smoke``, accepted and implied); ``--full`` trains the
published width on one card, weights drawn from ``--seed``.  The dense,
VLM, MoE and audio families train (whisper over the pipeline's random
frames); the SSM and hybrid families exit non-zero, naming the ROADMAP
entry for them.  As the JAX launcher does, it trains on the local mesh,
``(world, 1)`` over ``("data", "model")``, through a ``Partitioner`` in
the config's mode; every rank takes the same batches and keeps its rows.

Started by ``torchrun``, the launcher joins its process group (``gloo``:
the ranks may share a card) and trains over its ranks, each on
``cuda:LOCAL_RANK`` modulo the cards, with ``--ckpt-dir`` shared by all;
a start over another rank count restores the newest checkpoint resharded
onto its mesh.  Rank 0 prints; every rank traces into ``rank<R>`` under
``--trace-dir``.  Without ``torchrun`` it trains on one rank::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --device cpu --arch stablelm-3b --steps 4 --ckpt-dir /tmp/ck
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import render, tally_trace
from repro_torch.launch.mesh import describe, join_torchrun_group, leave_group, make_local_mesh
from repro_torch.models import Model, ShapeSpec
from repro_torch.sharding import Partitioner
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (the default without --full)")
    ap.add_argument("--full", action="store_true", help="published width on one card, not .smoke()")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--trace", choices=["off", "minimal", "default", "full"], default="off")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument(
        "--trace-dir", default=os.path.join(tempfile.gettempdir(), "thapi_train_torch")
    )
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.smoke and args.full:
        ap.error("--smoke and --full exclude each other")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    try:
        return _train(args, join_torchrun_group(device))
    finally:
        leave_group()


def _train(args, device) -> int:
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    mesh = make_local_mesh()
    rank = torch.distributed.get_rank() if mesh.size > 1 else 0
    trace_dir = os.path.join(args.trace_dir, f"rank{rank}") if mesh.size > 1 else args.trace_dir
    model = Model(cfg, mesh)
    try:
        model.check_trainable()
    except NotImplementedError as e:
        print(f"[train] {e}", file=sys.stderr)
        return 2
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    trainer = Trainer(
        model,
        shape,
        device,
        TrainConfig(
            peak_lr=args.lr,
            warmup=max(2, args.steps // 10),
            total_steps=max(args.steps, 10),
            microbatches=args.microbatches,
            grad_compression=args.grad_compression,
        ),
        TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 2, 1), ckpt_dir=args.ckpt_dir),
        rng_seed=args.seed,
        partitioner=Partitioner(mesh, fsdp=cfg.fsdp),
    )
    tracer = None
    if args.trace != "off":
        tracer = Tracer(
            TraceConfig(out_dir=trace_dir, mode=args.trace, sample=args.sample, rank=rank)
        ).start()
    try:
        res = trainer.run()
    finally:
        if tracer is not None:
            tracer.stop()
    if rank:
        return 0
    h = res["history"]
    print(f"{args.arch}: loss {h[0]['loss']:.3f} → {h[-1]['loss']:.3f} in {res['steps_run']} steps "
          f"on {device} ({cfg.name}, {cfg.dtype}, mesh {describe(mesh)})")
    if tracer is not None:
        print(render(tally_trace(trace_dir), top=8))
    return 0


if __name__ == "__main__":
    sys.exit(main())
