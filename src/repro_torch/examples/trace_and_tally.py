"""The paper's running example (§1.1): rich memcpy interception, on the card.

Runs an H2D and a D2H transfer under a full-mode trace, pretty-prints the
memcpy events to show the full call context (src/dst pointers, size), and
deduces H2D against D2H from the pointers' address classes alone (host
0x00…, device 0xff…) — the zeCommandListAppendMemoryCopy walkthrough.

    PYTHONPATH=src python -m repro_torch.examples.trace_and_tally [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a card it raises.
"""

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core import TraceConfig, Tracer, traced_device_get, traced_device_put
from repro_torch.core.babeltrace import CTFSource
from repro_torch.core.plugins.pretty import format_event


def memcpy_rows(trace_dir: str) -> list:
    """(pretty line, deduced direction or None) of each memcpy event."""
    src = CTFSource(trace_dir)
    rows = []
    for ev in src:
        if "memcpy" not in ev.name:
            continue
        kind = None
        if ev.name.endswith("entry"):
            f = ev.asdict()
            kind = "H2D" if f["src"] >> 56 == 0 and f["dst"] >> 56 == 0xFF else (
                "D2H" if f["src"] >> 56 == 0xFF and f["dst"] >> 56 == 0 else "?")
        rows.append((format_event(ev, src.meta.clock), kind))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    trace_dir = tempfile.mkdtemp(prefix="thapi_memcpy_")
    with Tracer(TraceConfig(out_dir=trace_dir, mode="full")):
        x = np.random.default_rng(0).normal(size=(1 << 16,)).astype(np.float32)
        dev = traced_device_put(x, device)  # H2D
        back = traced_device_get(dev * 2)  # D2H
    if not np.array_equal(back, x * 2):
        raise AssertionError("the round trip changed the data")

    print(f"memcpy events on {device} (full argument context, THAPI-style):\n")
    for line, kind in memcpy_rows(trace_dir):
        print(line)
        if kind is not None:
            print(f"  → deduced {kind} from the pointers' address classes")
    print("\n(compare §1.1: TAU records name+timestamp only; THAPI records the"
          "\n full call context, enabling exactly this deduction.)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
