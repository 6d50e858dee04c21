"""Dry run of every (architecture × its applicable shapes) on one device.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's
production step on the production meshes and reads XLA's cost and memory
analyses.  Here the mesh is one device, and the production step runs once
on meta tensors (shapes and dtypes, no storage) under ``Counter``, which
counts what the eager step does:

    train    ``loss_and_grads`` then ``adamw_update``, as ``build_train_step``
             runs them (bf16 optimizer state where the config shards its
             weights, as the JAX dry run's ``_adamw_for``)
    prefill  ``Model.prefill``, the cache as long as the prompt
    decode   ``Model.decode_step`` against a cache of ``seq_len`` rows

The full depth is counted directly: eager PyTorch runs every layer, where
XLA counts a scanned loop body once (``roofline.extrapolate`` over 1- and
2-unit counts stays as a cross-check).  A hand-written kernel's call on a
meta tensor returns outputs of the kernel's shapes from its shape function
and is counted as one unit of the FLOPs and bytes its op gives its trace
span (``kernels/ops.py``).  The SSM and hybrid families' train cells are
refused, as ``Model.check_trainable`` refuses them (ROADMAP section 4).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k -o out/dryrun
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import sys
import threading
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.models import SHAPES, Model, ShapeSpec
from repro_torch.models.config import applicable_shapes
from repro_torch.models.param import DTYPES, Spec
from repro_torch.models.param import shapes as spec_shapes
from repro_torch.models.param import zeros as spec_zeros
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainConfig, build_train_step

MESH = "1 device"


def _touched(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` spans: a dimension broadcast by
    a zero stride (``expand``) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class Counter(TorchDispatchMode):
    """Counts what the operators run under it do on ``device``:

    * ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
      convolutions, attention), plus each kernel call's analytic FLOPs;
    * ``bytes``: each operator's inputs plus outputs, each tensor by the
      distinct elements it spans; an operator whose outputs all alias its
      inputs without writing them (a view) counts 0; plus each kernel
      call's analytic bytes;
    * ``peak``: the most storage live at once, counting every storage from
      the first time an operator, ``track`` or a kernel call sees it until
      it is freed (the inputs included);
    * ``kernels``: the kernel calls by name.

    Operators on no tensor of ``device`` are not counted (the RoPE table is
    made once on the CPU for every device).  Inside a kernel call nothing is
    counted: on the CPU the plain version's own operators stand for one
    launch, and its outputs are tracked when it returns.
    """

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.arg_bytes = 0
        self.out_bytes = 0
        self.kernels: collections.Counter = collections.Counter()
        self._sizes: dict = {}  # id(storage) -> nbytes, while it lives
        self._finalizers: list = []
        self._lock = threading.Lock()  # storages may be freed on autograd's threads
        self._paused = 0
        self._token = None

    def __enter__(self):
        self._token = ops.counting.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops.counting.reset(self._token)
            for f in self._finalizers:
                f.detach()

    # -- storage lifetimes ------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        if t.device != self.device:
            return 0
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._sizes:
                return 0
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        self._finalizers.append(weakref.finalize(st, self._free, key))
        return n

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._sizes.pop(key)

    def track(self, *trees) -> int:
        """Tracks the tensors of ``trees``; returns the bytes of the storages
        seen for the first time."""
        return sum(self._track(t) for t in tree_leaves(trees) if isinstance(t, torch.Tensor))

    # -- counting ---------------------------------------------------------------
    def kernel(self, name: str, flops: int, nbytes: int, run):
        """One hand-written kernel call: its analytic FLOPs and bytes, and
        ``run()``'s outputs tracked."""
        self.flops += flops
        self.bytes += nbytes
        self.kernels[name] += 1
        self._paused += 1
        try:
            out = run()
        finally:
            self._paused -= 1
        self.track(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not any(t.device == self.device for t in ins + outs):
            return out
        for t in ins:
            self._track(t)
        new = sum(self._track(t) for t in outs)
        writes = any(r.alias_info is not None and r.alias_info.is_write for r in func._schema.returns)
        if new or writes or not outs:
            self.bytes += sum(_touched(t) for t in ins) + sum(_touched(t) for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def cells(arch_filter: str, shape_filter: str) -> List[Tuple[str, str]]:
    out = []
    for arch in ARCHS if arch_filter == "all" else [arch_filter]:
        for shape in applicable_shapes(get_config(arch)):
            if shape_filter in ("all", shape.name):
                out.append((arch, shape.name))
    return out


def _adamw_for(cfg) -> AdamWConfig:
    # the 1T-parameter config keeps bf16 optimizer state, as the JAX dry run's
    return AdamWConfig(state_dtype="bfloat16" if cfg.fsdp else "float32")


def _draw(tree, cfg, gen: torch.Generator):
    """Real inputs for a batch spec tree: token ids below the vocabulary,
    normal draws for embeddings."""
    if isinstance(tree, Spec):
        if tree.dtype == "int32":
            return torch.randint(0, cfg.vocab_size, tree.shape, generator=gen, device=gen.device, dtype=torch.int32)
        return torch.randn(tree.shape, generator=gen, device=gen.device).to(DTYPES[tree.dtype or cfg.dtype])
    return {k: _draw(v, cfg, gen) for k, v in tree.items()}


def step_inputs(model: Model, shape: ShapeSpec, device="meta", seed: int = 0) -> tuple:
    """The step's inputs: (state, batch) for train, (params, batch) for
    prefill, (params, cache, batch) for decode.  Meta tensors on ``meta``;
    elsewhere weights drawn from ``seed``, random token ids and a zero
    cache."""
    cfg = model.cfg
    if torch.device(device).type == "meta":
        params = model.shapes()
        batch = spec_shapes(model.batch_specs(shape), cfg.dtype)
    else:
        gen = torch.Generator(device).manual_seed(seed)
        params = model.init(gen)
        batch = _draw(model.batch_specs(shape), cfg, gen)
    if shape.kind == "train":
        return {"params": params, "opt": adamw_init(params, _adamw_for(cfg))}, batch
    if shape.kind == "prefill":
        return params, batch
    return params, spec_zeros(model.cache_specs(shape), cfg.dtype, device), batch


def count_step(model: Model, shape: ShapeSpec, inputs: tuple, device="meta") -> Counter:
    """Runs ``shape``'s production step once on ``inputs`` under a
    ``Counter``; the step's inputs count as live from the start."""
    if shape.kind == "train":  # Model.loss refuses a family whose training is not ported
        step = build_train_step(model, shape, TrainConfig(adamw=_adamw_for(model.cfg)), device)
    elif shape.kind == "prefill":
        def step(params, batch):
            return model.prefill(params, batch, shape.seq_len)
    else:
        step = model.decode_step
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with grad, Counter(device) as c:
        c.arg_bytes = c.track(inputs)
        out = step(*inputs)
        ins = _storages(inputs)
        c.out_bytes = sum(n for key, n in _storages(out).items() if key not in ins)
    return c


def _storages(tree) -> dict:
    """{id(storage): nbytes} of the tensors of ``tree``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def device_kind(kind: Optional[str]) -> rl.Card:
    """The named card, else the card at hand, else the H100 row."""
    if kind is None:
        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else rl.H100.name
    return rl.card(kind)


def _memory_of(card: rl.Card) -> int:
    if torch.cuda.is_available() and torch.cuda.get_device_name(0) == card.name:
        return torch.cuda.get_device_properties(0).total_memory
    return card.memory_bytes


def run_cell(arch: str, shape_name: str, card: Optional[rl.Card] = None, memory: Optional[int] = None,
             cfg=None, shape: Optional[ShapeSpec] = None) -> dict:
    """One cell's JSON: ``ok`` with its roofline, or ``refused`` with the
    reason for a family whose training is not ported.  ``card`` defaults to
    the card at hand (else the H100 row), ``memory`` to its memory;
    ``cfg`` and ``shape`` override the registry's (a reduced depth, a
    smaller batch)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    card = card if card is not None else device_kind(None)
    memory = memory if memory is not None else _memory_of(card)
    head = {"arch": arch, "shape": shape.name, "mesh": MESH, "n_devices": 1}
    model = Model(cfg)
    if shape.kind == "train":
        try:
            model.check_trainable()
        except NotImplementedError as e:
            return {**head, "ok": False, "refused": str(e)}
    t0 = time.monotonic()
    c = count_step(model, shape, step_inputs(model, shape))
    rf = rl.analyze(c, cfg, shape, 1, card)
    return {
        **head,
        "ok": True,
        "t_dryrun_s": round(time.monotonic() - t0, 3),
        "fits": rf.peak_bytes <= memory,
        "memory_bytes": memory,
        "kernel_calls": dict(c.kernels),
        "roofline": rf.to_json(),
    }


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def render(rows: List[dict]) -> str:
    """The ``benchmarks/roofline.py`` table, with the peak against the card
    and each cell's dry-run seconds."""
    hdr = (
        f"{'arch':22s} {'shape':12s} {'mesh':10s} {'compute':>9s} {'memory':>9s} "
        f"{'coll':>9s} {'bound':>10s} {'MODEL/FLOP':>10s} {'roofline%':>9s} {'peak GiB':>9s} "
        f"{'fits':>5s} {'dry s':>6s}"
    )
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if "refused" in r:
            out.append(f"{r['arch']:22s} {r['shape']:12s} REFUSED: {r['refused']}")
            continue
        if not r.get("ok"):
            out.append(f"{r['arch']:22s} {r['shape']:12s} FAILED: {r.get('error', '?')[:60]}")
            continue
        rf = r["roofline"]
        out.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
            f"{rf['t_compute']:9.4f} {rf['t_memory']:9.4f} {rf['t_collective']:9.4f} "
            f"{rf['bottleneck']:>10s} {rf['useful_flops_ratio']:10.3f} "
            f"{100 * rf['roofline_fraction']:8.1f}% {rf['peak_bytes'] / 2**30:9.2f} "
            f"{'yes' if r['fits'] else 'no':>5s} {r['t_dryrun_s']:6.2f}"
        )
    return "\n".join(out)


def _result_path(out_dir: str, arch: str, shape: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__1device.json")


def _cell(arch: str, shape: str, card: rl.Card, memory: int) -> dict:
    """``run_cell``, a failure recorded with its traceback (a worker keeps
    going)."""
    try:
        return run_cell(arch, shape, card, memory)
    except Exception as e:  # a failing cell is a bug: record it loudly
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": MESH, "n_devices": 1, "ok": False,
                "error": f"{type(e).__name__}: {e}"}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", choices=["all"] + ARCHS)
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("-o", "--out", default=None, help="write per-cell JSON here")
    ap.add_argument("--jobs", type=int, default=1, help="parallel worker processes")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device-kind", default=None,
                    help=f"the card whose figures bound the step (default: the card at hand, else {rl.H100.name!r})")
    args = ap.parse_args(argv)

    todo = cells(args.arch, args.shape)
    if args.list:
        for c in todo:
            print(*c)
        return 0
    card = device_kind(args.device_kind)
    memory = _memory_of(card)  # here, so that no worker touches the card
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        if args.skip_existing:
            todo = [c for c in todo if not os.path.exists(_result_path(args.out, *c))]

    t0 = time.monotonic()
    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            rows = list(pool.map(_cell, *zip(*todo), [card] * len(todo), [memory] * len(todo))) if todo else []
    else:
        rows = [_cell(arch, shape, card, memory) for arch, shape in todo]
    for r in rows:
        if args.out:
            with open(_result_path(args.out, r["arch"], r["shape"]), "w") as f:
                json.dump(r, f, indent=1)
    print(f"[dryrun] {card.name}, one device, meta tensors")
    print(render(rows))
    refused = sum(1 for r in rows if "refused" in r)
    failed = sum(1 for r in rows if not r["ok"] and "refused" not in r)
    print(f"dry-run: {len(rows) - refused - failed}/{len(rows)} cells ran, {refused} refused "
          f"(training not ported, ROADMAP section 4), {failed} failed, {time.monotonic() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
