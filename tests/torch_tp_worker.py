"""One rank of the port's tensor-parallel checks, run by
``test_torch_tensor_parallel.py``.

    python tests/torch_tp_worker.py RANK WORLD STORE IN.npz OUT_DIR CASES_JSON

Joins a ``gloo`` process group over the ``FileStore`` at ``STORE`` and, on
the 1x4 and the 2x2 ``("data", "model")`` meshes of ``make_local_mesh``,
runs every case on the numpy inputs of ``IN.npz`` (``CASES_JSON`` names
each case's config: an architecture's smoke config and the fields replaced
in it):

* ``grads``: the loss of the first batch and every gradient, gathered
  whole, from ``loss_and_grads`` on this rank's blocks and rows and
  ``reduce_grads``;
* ``train``: five steps of ``build_train_step`` with the partitioner;
* ``flops``: the matrix FLOPs ``launch.dryrun.Counter`` counts in one
  forward of ``Model.loss`` on this rank's blocks and rows;
* ``serve``: ``ServeEngine(..., partitioner=...)`` on the prompts, every
  request's tokens, every prefill's and decode step's logits, and this
  rank's block of every cache leaf beside ``local_block`` of the one-rank
  engine's cache after the same schedule;
* ``vocab``: the loss of configs whose vocabulary is split with padding
  or does not divide the axis.

Writes ``OUT_DIR/rank<R>.npz``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import Counter
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model, ShapeSpec
from repro_torch.serve.artifacts import cache_specs
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.sharding import Partitioner, gather_whole, local_block, place
from repro_torch.sharding import collectives as C
from repro_torch.train.train_step import (
    TrainConfig,
    build_train_step,
    init_state,
    loss_and_grads,
    reduce_grads,
    state_specs,
)

MESHES = {"1x4": 4, "2x2": 2}
TRAIN = ShapeSpec("tp", "train", 16, 4)
STEPS = 5
TCFG = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
SERVE = ServeConfig(batch_slots=4, cache_len=32, max_new_tokens=4)


def config(case) -> object:
    """A case's config: ``[arch, {field: value}]``, MoE fields under "moe"."""
    arch, fields = case
    cfg = get_config(arch).smoke()
    fields = dict(fields)
    moe = fields.pop("moe", None)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **fields)


def tree_of(inp, prefix: str) -> dict:
    out: dict = {}
    for key in inp.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1 :].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(inp[key]))
    return out


def batch_of(inp, name: str, i: int) -> dict:
    return {k: torch.from_numpy(np.array(inp[f"{name}/batch{i}/{k}"])) for k in ("tokens", "labels")}


def rows(x: torch.Tensor, mesh) -> torch.Tensor:
    n, d = mesh.shape["data"], mesh.index("data")
    b = x.shape[0] // n
    return x[d * b : (d + 1) * b]


def _spec_map(fn, t, s):
    if isinstance(t, dict):
        return {k: _spec_map(fn, t[k], s[k]) for k in t}
    return fn(t, s)


def blocks_of(model, part, whole: dict):
    """(this rank's blocks of ``whole``, their specs, the view the step hands
    the model)."""
    specs = part.tree_pspecs(model.shapes(), model.axes())
    blocks = _spec_map(lambda t, s: local_block(t, s, part.mesh).clone(), whole, specs)

    def view(p):
        return place(p, specs, part.mesh, keep_local=model.keep_local, axes=model.axes())

    return blocks, specs, view


def grads_case(name, cfg, inp, part, out: dict, tag: str) -> None:
    mesh = part.mesh
    model = Model(cfg, mesh)
    blocks, specs, view = blocks_of(model, part, tree_of(inp, f"{name}/params"))
    batch = {k: rows(v, mesh) for k, v in batch_of(inp, name, 0).items()}
    loss, grads, _ = loss_and_grads(model, blocks, batch, 1, view)
    grads = reduce_grads(grads, specs, mesh)
    out[f"{tag}/{name}/loss"] = C.pmean(loss, mesh, mesh.axis_names).numpy()
    for key, g in tree.items(_spec_map(lambda g, s: gather_whole(g, s, mesh), grads, specs)):
        out[f"{tag}/{name}/grad/{key}"] = g.numpy()


def train_case(name, cfg, inp, part, out: dict, tag: str) -> None:
    mesh = part.mesh
    model = Model(cfg, mesh)
    state = init_state(model, TCFG, torch.Generator().manual_seed(0), part)
    _, specs = state_specs(model, part, TCFG)
    blocks = _spec_map(lambda w, s: local_block(w, s, mesh), tree_of(inp, f"{name}/params"), specs["params"])
    tree.map(lambda dst, src: dst.copy_(src), state["params"], blocks)
    step = build_train_step(model, TRAIN, TCFG, "cpu", part)
    hist = []
    for i in range(STEPS):
        state, m = step(state, batch_of(inp, name, i))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    out[f"{tag}/{name}/hist"] = np.array(hist)


def flops_case(name, cfg, inp, part, out: dict, tag: str) -> None:
    mesh = part.mesh
    model = Model(cfg, mesh)
    blocks, _, view = blocks_of(model, part, tree_of(inp, f"{name}/params"))
    batch = {k: rows(v, mesh) for k, v in batch_of(inp, name, 0).items()}
    with torch.no_grad(), Counter("cpu") as c:
        model.loss(view(blocks), batch)
    out[f"{tag}/{name}/flops"] = np.array(c.flops, dtype=np.int64)


def _recording(eng, log: dict) -> None:
    """Record the logits of every prefill and decode step the engine runs."""
    decode = eng._decode

    def dec(*a):
        out = decode(*a)
        log["decode"].append(out[0].detach().clone())
        return out

    class Prefills(dict):
        def __setitem__(self, key, step):
            def run(p, b):
                out = step(p, b)
                log["prefill"].append(out[0].detach().clone())
                return out

            super().__setitem__(key, run)

    eng._decode = dec
    eng._prefill_steps = Prefills()


def serve_case(name, cfg, inp, part, out: dict, tag: str) -> None:
    prompts = [np.array(inp[k]) for k in sorted(k for k in inp.files if k.startswith("serve/prompt"))]
    whole = tree_of(inp, f"{name}/params")
    engines = {}
    for kind, p in (("mesh", part), ("one", None)):
        eng = ServeEngine(Model(cfg), whole, SERVE, partitioner=p)
        log = {"prefill": [], "decode": []}
        _recording(eng, log)
        reqs = [eng.submit(pr) for pr in prompts]
        with torch.no_grad():
            eng.run_until_drained()
        engines[kind] = eng
        if kind == "mesh":
            out[f"{tag}/{name}/serve/tokens"] = np.array([r.out_tokens for r in reqs])
            out[f"{tag}/{name}/serve/prefill"] = torch.cat(log["prefill"]).numpy()
            out[f"{tag}/{name}/serve/decode"] = torch.stack(log["decode"]).numpy()
    mesh_eng, one = engines["mesh"], engines["one"]
    specs = cache_specs(mesh_eng.model, part, ShapeSpec("serve", "decode", SERVE.cache_len, SERVE.batch_slots))
    for key in ("k", "v", "len"):
        got, whole_leaf = mesh_eng.cache[key], one.cache[key]
        want = local_block(whole_leaf, specs[key], part.mesh)
        out[f"{tag}/{name}/cache/{key}"] = np.array(
            [float((got.double() - want.double()).abs().max()), got.numel(), whole_leaf.numel()])


def vocab_case(name, cfg, inp, part, out: dict, tag: str) -> None:
    mesh = part.mesh
    model = Model(cfg, mesh)
    blocks, _, view = blocks_of(model, part, tree_of(inp, f"{name}/params"))
    batch = {k: rows(v, mesh) for k, v in batch_of(inp, name, 0).items()}
    with torch.no_grad():
        loss, _ = model.loss(view(blocks), batch)
    out[f"{tag}/{name}/loss"] = C.pmean(loss, mesh, mesh.axis_names).numpy()
    out[f"{tag}/{name}/vocab_block"] = np.array(view(blocks)["embed"]["tok"].at_use().shape[0])


KINDS = {"grads": grads_case, "train": train_case, "flops": flops_case, "serve": serve_case, "vocab": vocab_case}


def main(argv) -> int:
    rank, world, store, in_path, out_dir, cases = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4], argv[5]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    torch.manual_seed(0)
    inp = np.load(in_path)
    cases = json.loads(cases)
    out: dict = {}
    for tag, mp in MESHES.items():
        part = Partitioner(make_local_mesh(model_parallel=mp))
        out[f"{tag}/mesh"] = np.array([part.mesh.index("data"), part.mesh.index("model")])
        for name, case in cases.items():
            for kind in case["kinds"]:
                KINDS[kind](name, config(case["config"]), inp, part, out, tag)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
