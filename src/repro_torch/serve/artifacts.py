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

Under a ``Partitioner`` (``sharding.Partitioner``) the artifacts are the
JAX ``param_artifacts`` / ``prefill_artifacts`` / ``decode_artifacts``'
shardings as specs: each rank holds its block of every parameter
(:func:`place_params`), the batch's rows over the data axes and its block
of every cache leaf (:func:`cache_specs`: slots over the data axes, KV
heads over "model", as the JAX engine's cache shardings; a family that
computes a layer whole keeps its "model" dimensions whole).  The meshed
decode step takes this rank's rows of the token batch and returns every
slot's logits, gathered whole over the ranks as the JAX step's
unsharded output.  It is a graph on a one-rank mesh and on a backend whose
collectives a graph captures; over ``gloo``, which stages every collective
through host memory, a graph cannot capture the step, and it runs
eagerly (:func:`eager_reason` says why, from the mesh's size and backend).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.interception import _tensors
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.param import Spec
from repro_torch.models.param import axes as spec_axes
from repro_torch.models.param import shapes as spec_shapes
from repro_torch.sharding.partition import PartitionSpec, Partitioner, logical_to_pspec
from repro_torch.sharding.placement import Placed, local_block, place, reshard

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


def param_artifacts(model: Model, partitioner: Partitioner):
    """(the parameters as meta tensors, their specs): the shapes and
    shardings of the JAX ``param_artifacts``."""
    shapes = model.shapes()
    return shapes, partitioner.tree_pspecs(shapes, model.axes())


def batch_specs(model: Model, partitioner: Partitioner, shape: ShapeSpec):
    """The specs of ``shape``'s batch: its rows over the data axes."""
    tree = model.batch_specs(shape)
    return partitioner.tree_pspecs(spec_shapes(tree, model.cfg.dtype), spec_axes(tree))


def cache_specs(model: Model, partitioner: Partitioner, shape: ShapeSpec):
    """The specs of the serving cache of ``shape`` as the model computes it
    on the partitioner's mesh (``Model.on_mesh``): the slots over the data
    axes and, for a family that computes its KV heads locally, the KV heads
    over "model", as the JAX engine's cache shardings in ``tp`` mode; every
    other dimension whole (``serve2d``'s sequence over "model" is a layout
    the port's decode attention does not compute with)."""
    keep = set(model.on_mesh(partitioner.mesh).keep_local) | {"batch"}
    rules = {a: (r if a in keep else ()) for a, r in partitioner.rules.items()}
    tree = model.cache_specs(shape)

    def walk(s, a):
        if isinstance(s, Spec):
            return logical_to_pspec(a, s.shape, partitioner.mesh, rules)
        if isinstance(s, dict):
            return {k: walk(s[k], a[k]) for k in s}
        return [walk(x, y) for x, y in zip(s, a)]

    return walk(tree, spec_axes(tree))


def prefill_artifacts(model: Model, partitioner: Partitioner, shape: ShapeSpec):
    """(parameter specs, batch specs, the specs of the cache it fills): the
    shardings of the JAX ``prefill_artifacts``."""
    return param_artifacts(model, partitioner)[1], batch_specs(model, partitioner, shape), \
        cache_specs(model, partitioner, shape)


def place_params(model: Model, params, partitioner: Partitioner):
    """``params`` as this rank's blocks (``sharding.Placed``) under the
    partitioner's specs: a whole tensor is cut to its block (a copy where
    the block is a part, so the whole may be freed); a ``Placed`` leaf is
    taken as it is."""
    mesh = partitioner.mesh
    specs = param_artifacts(model, partitioner)[1]

    def block(t, s):
        if isinstance(t, dict):
            return {k: block(t[k], s[k]) for k in t}
        if isinstance(t, Placed):
            return t.local
        b = local_block(t, s, mesh)
        return b.clone() if b.numel() < t.numel() else b

    return place(block(params, specs), specs, mesh, keep_local=model.keep_local, axes=model.axes())


def eager_reason(partitioner: Optional[Partitioner]) -> Optional[str]:
    """Why a meshed decode step cannot be a CUDA graph, or None: over a
    ``gloo`` group of more than one rank every collective is a host copy
    and a host-side reduction, which no graph captures."""
    mesh = None if partitioner is None else partitioner.mesh
    if mesh is None or mesh.size == 1 or dist.get_backend() != "gloo":
        return None
    return (f"the decode step runs eagerly: its collectives go over gloo between {mesh.size} ranks, "
            "through host memory, which a CUDA graph cannot capture")


def decode_artifacts(model: Model, device, partitioner: Optional[Partitioner] = None) -> Callable:
    """The decode step the engine wraps in its ``TracedStep``: the model's
    ``decode_step`` on the CPU, a :class:`DecodeGraph` of it on the card.
    Under a ``partitioner`` the step takes this rank's rows of the token
    batch and returns the logits of every slot; on the card it is a graph
    unless :func:`eager_reason` gives a reason."""
    device = torch.device(device)
    step = model.decode_step if partitioner is None else _meshed_decode(model, partitioner)
    if device.type == "cpu":
        return step
    if device.type == "cuda":
        return step if eager_reason(partitioner) else DecodeGraph(step, device)
    raise ValueError(f"no decode step for device {device}")


def _meshed_decode(model: Model, partitioner: Partitioner) -> Callable:
    mesh = partitioner.mesh

    def step(params, cache, batch):
        token = batch["token"]
        spec = partitioner.pspec(("batch",), tuple(token.shape))
        logits, cache = model.decode_step(params, cache, {"token": local_block(token, spec, mesh)})
        return reshard(logits, spec, PartitionSpec(), mesh), cache

    return step
