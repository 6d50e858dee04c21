"""One rank of the port's 2×2 mesh checks, run by ``test_torch_multidevice.py``.

    python tests/torch_mesh_worker.py RANK WORLD STORE IN.npz OUT_DIR

Joins a ``gloo`` process group over the ``FileStore`` at ``STORE``, builds
the 2×2 ``("data", "model")`` mesh with ``make_local_mesh(2)``, and runs
every case on the inputs in ``IN.npz`` (numpy, made by the test):

* ``moe``: the MoE smoke layer's ``moe_ffn`` over this rank's rows, on the
  sequence, replicated and 2-D paths, at the configured capacity factor, at
  0.5 and at 8.0, with ``kept_assignments``' record of the assignments
  kept; and each path at 8.0 in bf16;
* ``half``: bf16 and fp16 tensors through ``all_gather`` (and its
  backward, a summing reduce-scatter), ``all_to_all`` and ``psum``;
* ``cmean``: ``compressed_mean`` of this rank's row over "data" and "model";
* ``train``: the stablelm smoke step in ``tp`` and ``fsdp`` modes, with and
  without ``grad_compression``, three steps, this rank's block shapes, and
  each leaf's DTensor placements rebuilding the whole leaf from the blocks;
* ``grads``: the MoE smoke model's cross-entropy gradients on the mesh,
  gathered whole;
* ``trace``: a meshed prefill and decode step under a trace, and the
  collectives' rows of the tally.

Writes ``OUT_DIR/rank<R>.npz``.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model, ShapeSpec, moe
from repro_torch.optim.compression import compressed_mean
from repro_torch.sharding import collectives as C
from repro_torch.sharding import Partitioner, Placed, gather_whole, local_block
from repro_torch.train.train_step import (
    TrainConfig,
    build_train_step,
    init_state,
    loss_and_grads,
    reduce_grads,
    state_specs,
)

MOONSHOT, STABLELM = "moonshot-v1-16b-a3b", "stablelm-3b"
EXPERTS = ("w_gate", "w_up", "w_down")
#: (name, input key, serve_2d, mode whose placement the experts arrive in)
MOE_CASES = (("seq", "x_seq", False, "fsdp"), ("replicated", "x_dec", False, "tp"), ("2d", "x_dec", True, "serve2d"))
CAPACITY = {"cf": None, "cf05": 0.5, "cf8": 8.0}
TRAIN_MODES = (("tp", False), ("fsdp", False), ("tp", True), ("fsdp", True))
TRAIN_SHAPE = ShapeSpec("t", "train", 16, 4)
TRAIN_STEPS = 3


def tree_of(inp, prefix: str) -> dict:
    """The nested dict of tensors stored under ``prefix/`` in the npz."""
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


def flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def rows(x: torch.Tensor, mesh) -> torch.Tensor:
    n, d = mesh.shape["data"], mesh.index("data")
    b = x.shape[0] // n
    return x[d * b : (d + 1) * b]


def moe_cases(inp, mesh, out: dict) -> None:
    cfg = get_config(MOONSHOT).smoke()
    whole = {k: torch.from_numpy(np.array(inp[f"moe/{k}"])) for k in ("router",) + EXPERTS}
    axes = {k: a[1:] for k, a in Model(cfg).axes()["blocks"].items() if k in whole}
    for name, key, serve_2d, mode in MOE_CASES:
        part = Partitioner(mesh, mode=mode)
        for dtype in (torch.float32, torch.bfloat16):
            p = {"router": whole["router"].to(dtype)}
            for k in EXPERTS:
                spec = part.pspec(axes[k], tuple(whole[k].shape))
                p[k] = Placed(local_block(whole[k], spec, mesh).to(dtype), spec, mesh, whole_at_use=False)
            x = rows(torch.from_numpy(np.array(inp[key])), mesh).to(dtype)
            for tag, cf in CAPACITY.items() if dtype == torch.float32 else (("cf8", 8.0),):
                c = dataclasses.replace(cfg, serve_2d=serve_2d,
                                        moe=dataclasses.replace(cfg.moe, capacity_factor=cf or cfg.moe.capacity_factor))
                assert moe._path(c, x, mesh) == name, (moe._path(c, x, mesh), name)
                y, aux = moe.moe_ffn(c, p, x, mesh)
                if dtype == torch.bfloat16:
                    out[f"moe_bf16/{name}/y"] = y.float().numpy()
                    continue
                out[f"moe/{name}/{tag}/y"] = y.numpy()
                out[f"moe/{name}/{tag}/aux"] = aux.numpy()
                out[f"moe/{name}/{tag}/kept"] = moe.kept_assignments(c, p, x, mesh).numpy()


def half_cases(mesh, out: dict) -> None:
    """16-bit floats through the collectives, which move them as bytes and
    sum them in fp32: each rank's input, ``all_gather`` over "data" and its
    backward from a cotangent of the rank's own, ``all_to_all`` and
    ``psum`` over "model"."""
    rank = dist.get_rank()
    for dtype in (torch.bfloat16, torch.float16):
        tag = str(dtype).split(".")[1]
        x = torch.randn(4, 6, generator=torch.Generator().manual_seed(rank)).to(dtype)
        go = torch.randn(8, 6, generator=torch.Generator().manual_seed(10 + rank)).to(dtype)
        xr = x.clone().requires_grad_(True)
        gathered = C.all_gather(xr, mesh, "data", dim=0)
        (gx,) = torch.autograd.grad(gathered, xr, grad_outputs=go)
        for name, t in (("x", x), ("go", go), ("gather", gathered.detach()), ("gather_grad", gx),
                        ("all_to_all", C.all_to_all(x, mesh, "model")), ("psum", C.psum(x, mesh, "model"))):
            assert t.dtype == dtype, (name, t.dtype)
            out[f"half/{tag}/{name}"] = t.float().numpy()


def cmean_cases(inp, mesh, out: dict) -> None:
    g = torch.from_numpy(np.array(inp["cmean/g"]))[dist.get_rank()]
    for axis in ("data", "model"):
        out[f"cmean/{axis}"] = compressed_mean(g, mesh, axis).numpy()


def train_cases(inp, mesh, out: dict) -> None:
    cfg = get_config(STABLELM).smoke()
    full = tree_of(inp, "train/params")
    batches = [{k: torch.from_numpy(np.array(inp[f"train/batch{i}/{k}"])) for k in ("tokens", "labels")}
               for i in range(TRAIN_STEPS)]
    for mode, comp in TRAIN_MODES:
        model = Model(cfg, mesh)
        part = Partitioner(mesh, mode=mode)
        tcfg = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100, grad_compression=comp)
        state = init_state(model, tcfg, torch.Generator().manual_seed(0), part)
        _, specs = state_specs(model, part, tcfg)

        def load(dst, src, spec):
            if isinstance(dst, dict):
                for k in dst:
                    load(dst[k], src[k], spec[k])
            else:
                dst.copy_(local_block(src, spec, mesh))

        load(state["params"], full, specs["params"])
        tag = f"{mode}{'-int8' if comp else ''}"
        if not comp:
            placements_case(full, state["params"], specs["params"], part, f"train/{tag}/dtensor", out)
        step = build_train_step(model, TRAIN_SHAPE, tcfg, "cpu", part)
        hist = []
        for b in batches:
            state, m = step(state, b)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"train/{tag}/hist"] = np.array(hist)
        out.update(flat(tree_shapes(state["params"]), f"train/{tag}/shape/params"))
        out.update(flat(tree_shapes(state["opt"]["mu"]), f"train/{tag}/shape/mu"))
        out[f"train/{tag}/bytes"] = np.array(step.bytes_accessed)


def placements_case(full, blocks, specs, part, prefix: str, out: dict) -> None:
    """Each leaf's DTensor placements, and the whole leaf its blocks make
    as a DTensor with them (``full_tensor``) against the whole leaf."""
    from torch.distributed.tensor import DTensor

    def walk(f, b, s, key):
        if isinstance(f, dict):
            for k in f:
                walk(f[k], b[k], s[k], f"{key}/{k}")
            return
        pl = part.placements(s)
        whole = DTensor.from_local(b, part.mesh.device_mesh, pl).full_tensor()
        out[f"{prefix}{key}"] = np.array([torch.equal(whole, f), len(pl), sum(p.is_shard() for p in pl)])

    walk(full, blocks, specs, "")


def tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    return np.array(tree.shape, dtype=np.int64)


def grads_case(inp, mesh, out: dict) -> None:
    base = get_config(MOONSHOT).smoke()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    model = Model(cfg, mesh)
    part = Partitioner(mesh)
    full = tree_of(inp, "grads/params")
    specs = part.tree_pspecs(model.shapes(), model.axes())

    def blocks(t, s):
        if isinstance(t, dict):
            return {k: blocks(t[k], s[k]) for k in t}
        return local_block(t, s, mesh).clone()

    params = blocks(full, specs)

    def view(p):
        from repro_torch.sharding import place

        return place(p, specs, mesh, keep_local=model.keep_local, axes=model.axes())

    batch = {k: rows(torch.from_numpy(np.array(inp[f"grads/{k}"])), mesh) for k in ("tokens", "labels")}
    ce_model = _CeOnly(model)
    _, grads, _ = loss_and_grads(ce_model, params, batch, 1, view)
    grads = reduce_grads(grads, specs, mesh)

    def whole(g, s):
        if isinstance(g, dict):
            return {k: whole(g[k], s[k]) for k in g}
        return gather_whole(g, s, mesh)

    out.update(flat(whole(grads, specs), "grads/g"))


class _CeOnly:
    """The model with its loss the cross-entropy alone (the aux term is a
    per-shard estimate on a mesh, the whole batch's on one device)."""

    def __init__(self, model):
        self.model = model

    def loss(self, params, batch):
        _, metrics = self.model.loss(params, batch)
        return metrics["ce"], {}


def trace_case(inp, mesh, out: dict, trace_dir: str) -> None:
    cfg = get_config(MOONSHOT).smoke()
    model = Model(cfg, mesh)
    full = tree_of(inp, "grads/params")
    part = Partitioner(mesh)
    specs = part.tree_pspecs(model.shapes(), model.axes())
    blocks = full["blocks"]
    params = dict(full)
    params["blocks"] = {k: (Placed(local_block(v, specs["blocks"][k], mesh).clone(), specs["blocks"][k], mesh,
                                   whole_at_use=False, stacked=True) if k in EXPERTS else v)
                        for k, v in blocks.items()}
    tokens = rows(torch.from_numpy(np.array(inp["trace/tokens"])), mesh)
    with torch.no_grad():
        with Tracer(TraceConfig(out_dir=trace_dir, mode="default", rank=dist.get_rank())):
            logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=tokens.shape[1] + 4)
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            model.decode_step(params, cache, {"token": nxt})
    t = tally_trace(trace_dir)
    for (provider, api), st in t.device_apis.items():
        out[f"trace/{provider}/{api}"] = np.array(st.calls)
    out["trace/logits"] = logits.numpy()


def main(argv) -> int:
    rank, world, store, in_path, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    torch.manual_seed(0)
    mesh = make_local_mesh(model_parallel=2)
    inp = np.load(in_path)
    out: dict = {"mesh": np.array([mesh.index("data"), mesh.index("model")])}
    moe_cases(inp, mesh, out)
    half_cases(mesh, out)
    cmean_cases(inp, mesh, out)
    train_cases(inp, mesh, out)
    grads_case(inp, mesh, out)
    trace_case(inp, mesh, out, os.path.join(out_dir, f"trace{rank}"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
