"""The decode step the engine runs: the port's counterpart of the JAX package's
``repro/serve/artifacts.py::decode_artifacts``.

The JAX engine's decode step is one compiled executable whose cache argument
is donated, dispatched once a step.  Its counterpart on the card is one CUDA
graph: the first call runs the step eagerly (the first step's real result,
and the warm-up that builds every kernel library, sets every kernel
attribute and moves the RoPE frequencies to the card), then captures the
step into a graph over the tensors it was handed — the parameters, every
cache leaf and the engine's token buffer.  Every later call replays the
graph, which reads and writes those same storages, and returns the graph's
static logits and the cache.  A call handed other storages raises: a graph
replays only what it captured.  The model's ``decode_step`` already writes
the cache it is handed in place, so the donation is real.

Prefill stays eager: a graph per prompt length would hold memory for each.

The hand-written kernels count their launches in their wrapper, which runs
at the eager step and at the capture, never at a replay.  A replay runs the
launches its capture recorded, so the kernels' launches that ran are the
wrappers' counts, less :data:`captured_launches`, plus
:data:`replayed_launches`.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.interception import _tensors
from repro_torch.models import Model

#: launches recorded into decode graphs (not run) and launches run by their
#: replays, by kernel module, since a caller last cleared them (as it resets
#: the wrappers' ``launches``)
captured_launches: Dict[str, int] = {}
replayed_launches: Dict[str, int] = {}


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import flash_attention, rglru_scan, ssd_scan

    return {
        "ssd_scan": ssd_scan.launches,
        "rglru_scan": rglru_scan.launches,
        "flash_attention": flash_attention.launches,
    }


def storages(tree) -> tuple:
    """The storage address of every tensor of a nested dict/list/tuple, in order."""
    return tuple(t.data_ptr() for t in _tensors(tree))


class DecodeGraph:
    """A decode step on the card: eager and captured on the first call,
    replayed on every later one (see the module's docstring).

    ``captured`` holds the launches of each kernel module recorded into the
    graph, ``replays`` the replays so far.
    """

    def __init__(self, step: Callable, device: torch.device):
        self._step = step
        self.device = torch.device(device)
        self.graph = None
        self.captured: Dict[str, int] = {}
        self.replays = 0
        self._out = None
        self._ptrs = ()

    def __call__(self, params, cache, batch):
        if self.graph is None:
            return self._run_and_capture(params, cache, batch)
        if storages((params, cache, batch)) != self._ptrs:
            raise RuntimeError(
                "decode graph: called with other tensors than it captured; the "
                "engine keeps its parameters, cache leaves and token buffer in place"
            )
        self.graph.replay()
        self.replays += 1
        for name, n in self.captured.items():
            replayed_launches[name] = replayed_launches.get(name, 0) + n
        return self._out

    def _run_and_capture(self, params, cache, batch):
        # The first step runs on the stream the capture will use, so whatever
        # a library sets up per stream is in place before the capture; it is
        # the only warm-up, so the live cache advances once.
        side = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._step(params, cache, batch)
        cur.wait_stream(side)
        for t in _tensors(out):  # made on the side stream, read on this one
            t.record_stream(cur)
        # after the first step: the hybrid's first step replaces its h leaves
        self._ptrs = storages((params, cache, batch))
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, stream=side):
            self._out = self._step(params, cache, batch)
        after = _launch_counts()
        self.captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for name, n in self.captured.items():
            captured_launches[name] = captured_launches.get(name, 0) + n
        if storages((params, cache, batch)) != self._ptrs:
            raise RuntimeError("decode graph: the captured step replaced a cache leaf")
        self.graph = graph
        return out


def decode_artifacts(model: Model, device) -> Callable:
    """The decode step the engine wraps in its ``TracedStep``: the model's
    ``decode_step`` on the CPU, a :class:`DecodeGraph` of it on the card."""
    device = torch.device(device)
    step = model.decode_step
    if device.type == "cpu":
        return step
    if device.type == "cuda":
        return DecodeGraph(step, device)
    raise ValueError(f"no decode step for device {device}")
