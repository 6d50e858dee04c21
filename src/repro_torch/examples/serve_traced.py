"""Serve a model with batched requests under tracing (§4.3 analogue): the
tally shows the framework layer (prefill/decode) over the dispatch layer
(dispatch/poll_ready spin lock in full mode) — the HIPLZ layering analysis.

The session also opens a live master (``serve_port=0``): mid-run the engine
reports its own live profile (``eng.live_profile()``), and ``iprof top`` can
attach to the printed port while the server runs — the §6 streaming service
from the serving side.

    PYTHONPATH=src python -m repro_torch.examples.serve_traced [--device cpu] [--arch A] [--full]

Runs on CUDA unless ``--device cpu`` is given; without a card it raises.
The default is the smoke width of ``stablelm-3b``, as in the JAX example;
``--full`` serves the published width with random weights from a seed.
"""

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import render, tally_trace
from repro_torch.core.plugins.timeline import write_timeline
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="stablelm-3b", choices=ARCHS)
    ap.add_argument("--full", action="store_true", help="published width, not .smoke()")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on the CPU")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=64, max_new_tokens=12))
    rng = np.random.default_rng(7)
    trace_dir = tempfile.mkdtemp(prefix="thapi_serve_")

    with Tracer(TraceConfig(out_dir=trace_dir, mode="full", sample=True, serve_port=0)) as tr:
        print(f"live profile served on 127.0.0.1:{tr.server.port} (iprof top attaches)")
        for _ in range(10):
            eng.submit(rng.integers(0, cfg.vocab_size, size=(16,)))
        done = eng.run_until_drained()
        live = eng.live_profile(top=5)
        if live:
            print("\n-- live profile (mid-session, engine's own view) --")
            print(live)

    print(f"served {len(done)} requests ({sum(len(r.out_tokens) for r in done)} tokens) "
          f"on {device} ({cfg.name}, {cfg.dtype})\n")
    print(render(tally_trace(trace_dir)))
    tl = trace_dir + "/timeline.json"
    n = write_timeline(trace_dir, tl)
    print(f"\n{n} timeline events → {tl} (open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
