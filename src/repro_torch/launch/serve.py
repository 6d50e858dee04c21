"""Serving launcher: batched requests through the engine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --full --requests 8 --trace default

Runs on CUDA unless ``--device cpu`` is given; without a card it raises
rather than fall back.  ``--full`` serves the published width (weights are
random, drawn from ``--seed``); the default is the ``.smoke()`` reduction.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import render, tally_trace
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--trace", choices=["off", "minimal", "default", "full"], default="off")
    ap.add_argument(
        "--trace-dir", default=os.path.join(tempfile.gettempdir(), "thapi_serve_torch")
    )
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="published width, not .smoke()")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on the CPU")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(
        model,
        params,
        ServeConfig(
            batch_slots=args.slots, cache_len=args.cache_len, max_new_tokens=args.new_tokens
        ),
    )
    rng = np.random.default_rng(args.seed)
    tracer = None
    if args.trace != "off":
        tracer = Tracer(TraceConfig(out_dir=args.trace_dir, mode=args.trace)).start()
    try:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            eng.submit(rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)))
        done = eng.run_until_drained()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        if tracer is not None:
            tracer.stop()
    tokens = sum(len(r.out_tokens) for r in done)
    print(
        f"served {len(done)} requests, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s on {device} ({cfg.name}, {cfg.dtype})"
    )
    if tracer is not None:
        print(render(tally_trace(args.trace_dir), top=10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
