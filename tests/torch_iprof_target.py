"""Tiny traced training workload of the port, for the iprof CLI tests: the
twin of ``iprof_target.py``, on the CPU (the port has no collective span
yet: it comes with the sharded trainer, ROADMAP item 5)."""

import torch

from repro_torch.core import TracedStep, train_step_span

_f = TracedStep(lambda x: (x * x).sum(), name="square_sum", device="cpu")


def main():
    x = torch.arange(64.0)
    for step in range(3):
        with train_step_span(step, 2, 32) as sp:
            sp.outs["loss"] = float(_f(x))
            sp.outs["grad_norm"] = 1.0
