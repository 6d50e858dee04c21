"""PyTorch port over four ``gloo`` CPU processes on a 2×2 ``("data",
"model")`` mesh, against the JAX package's ``shard_map`` on four fake XLA
host devices: the twin of ``test_multidevice.py``.

One module fixture writes numpy inputs, then runs at once the JAX side in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``test_multidevice.py`` sets it) and the port's four ranks
(``tests/torch_mesh_worker.py``, a ``FileStore`` under ``tmp_path``, no
port), each process with its own time limit.  Tolerances, in fp32 at
smoke width: ``moe_ffn`` outputs max|d| ≤ 1e-5 and aux relative ≤ 1e-6
against JAX on the sequence, replicated and 2-D paths, at the configured
capacity factor (1.25: the sequence path drops assignments), at 0.5 (every
path drops) and at 8.0 (none drops); the same assignments dropped (each
side within 1e-5 of the dense sum over the assignments the port kept);
the expert-parallel paths within the JAX test's 2e-4 of ``_moe_dense``,
and in bf16 within BF16_REL of its max|ref|; 16-bit floats through the
collectives bit for bit; ``compressed_mean`` within the int8 bound of the
plain mean and 1e-6 of JAX's; the sharded stablelm step's losses within 1e-4 of
the one-rank port step and of the JAX single-device step for 3 steps.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model, ShapeSpec, moe
from repro_torch.models.param import Spec
from repro_torch.train.train_step import TrainConfig, build_train_step, init_state, loss_and_grads

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
TIMEOUT_S = 600
MOONSHOT, STABLELM = "moonshot-v1-16b-a3b", "stablelm-3b"
PATHS = ("seq", "replicated", "2d")
MOE_KEY = {"seq": "x_seq", "replicated": "x_dec", "2d": "x_dec"}
CAPACITY = ("cf", "cf05", "cf8")
TRAIN_TAGS = ("tp", "fsdp", "tp-int8", "fsdp-int8")
STEPS = 3
#: max|d| / max|ref| of a bf16 expert-parallel path against bf16
#: ``_moe_dense`` on the same inputs, whose combine rounds in another
#: order: about three times the readings here (0.0032-0.0065)
BF16_REL = 2e-2

JAX_SCRIPT = textwrap.dedent(
    """
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.jaxcompat import device_mesh, make_mesh, shard_map
    from repro.models import Model, ShapeSpec
    from repro.models.moe import moe_ffn
    from repro.optim import adamw_init
    from repro.optim.compression import compressed_mean
    from repro.sharding import Partitioner
    from repro.train.train_step import TrainConfig, build_train_artifacts

    inp = np.load(sys.argv[1])
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"))

    def tree_of(prefix):
        t = {}
        for key in inp.files:
            if key.startswith(prefix + "/"):
                node = t
                parts = key[len(prefix) + 1:].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(inp[key])
        return t

    cfg = get_config("moonshot-v1-16b-a3b").smoke()
    moe_p = {k: jnp.asarray(inp["moe/" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    for name, key, s2d in (("seq", "x_seq", False), ("replicated", "x_dec", False), ("2d", "x_dec", True)):
        for tag, cf in (("cf", cfg.moe.capacity_factor), ("cf05", 0.5), ("cf8", 8.0)):
            c = dataclasses.replace(cfg, serve_2d=s2d, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
            with mesh:
                y, aux = jax.jit(lambda p, v: moe_ffn(c, p, v, mesh))(moe_p, jnp.asarray(inp[key]))
            out[f"moe/{name}/{tag}/y"] = np.asarray(y)
            out[f"moe/{name}/{tag}/aux"] = np.asarray(aux)

    g = jnp.asarray(inp["cmean/g"])  # row r on the device of mesh position r
    for axis, out_spec in (("data", P("model")), ("model", P("data"))):
        f = shard_map(lambda v: compressed_mean(v[0], axis)[None], mesh, P(("data", "model")), out_spec)
        out[f"cmean/{axis}"] = np.asarray(f(g))

    scfg = get_config("stablelm-3b").smoke()
    shape = ShapeSpec("t", "train", 16, 4)
    mesh1 = device_mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for comp in (False, True):
        tc = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100, grad_compression=comp)
        m1 = Model(scfg, mesh1)
        step, *_ = build_train_artifacts(m1, Partitioner(mesh1), shape, tc)
        params = tree_of("train/params")
        state = {"params": params, "opt": adamw_init(params, tc.adamw)}
        hist = []
        for i in range(3):
            batch = {k: jnp.asarray(inp[f"train/batch{i}/{k}"]) for k in ("tokens", "labels")}
            state, m = step(state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"train/{'int8' if comp else 'plain'}/hist"] = np.array(hist)
    m = Model(scfg, mesh)
    shapes, axes = m.shapes(), m.axes()
    for mode in ("tp", "fsdp"):
        part = Partitioner(mesh, mode=mode)
        flat_s, _ = jax.tree_util.tree_flatten_with_path(shapes)
        flat_a = jax.tree_util.tree_leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
        for (path, s), a in zip(flat_s, flat_a):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            sh = NamedSharding(mesh, part.pspec(a, s.shape)).shard_shape(s.shape)
            out[f"shard/{mode}/{key}"] = np.array(sh, dtype=np.int64)
    np.savez(sys.argv[2], **out)
    print("JAX_OK")
    """
)


def numpy_params(tree, rng) -> dict:
    """A spec tree's leaves drawn with numpy (normal × scale, zeros, ones),
    fp32, keyed by path."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, Spec):
            if t.init == "zeros":
                out[prefix] = np.zeros(t.shape, np.float32)
            elif t.init == "ones":
                out[prefix] = np.ones(t.shape, np.float32)
            else:
                out[prefix] = (rng.normal(size=t.shape) * t.scale).astype(np.float32)
            return
        for k in sorted(t):
            walk(t[k], f"{prefix}/{k}")

    walk(tree, "")
    return {k[1:]: v for k, v in out.items()}


def nested(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1 :].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def make_inputs(rng) -> dict:
    """The checks' inputs.  The MoE inputs share one direction plus noise,
    as a layer's hidden states do, so the router favours some experts and
    the capacities drop assignments."""
    inp = {}
    mcfg = get_config(MOONSHOT).smoke()
    d = mcfg.d_model
    layer = numpy_params(Model(mcfg).param_specs()["blocks"], rng)
    for k in ("router", "w_gate", "w_up", "w_down"):
        inp[f"moe/{k}"] = layer[k][0]
    common = rng.normal(size=d)
    inp["x_seq"] = (common + 0.5 * rng.normal(size=(4, 16, d))).astype(np.float32)
    inp["x_dec"] = (common + 0.5 * rng.normal(size=(16, 1, d))).astype(np.float32)
    inp["cmean/g"] = rng.normal(size=(4, 64)).astype(np.float32)
    scfg = get_config(STABLELM).smoke()
    for k, v in numpy_params(Model(scfg).param_specs(), rng).items():
        inp[f"train/params/{k}"] = v
    for i in range(STEPS):
        for k in ("tokens", "labels"):
            inp[f"train/batch{i}/{k}"] = rng.integers(0, scfg.vocab_size, size=(4, 16)).astype(np.int32)
    for k, v in numpy_params(Model(mcfg).param_specs(), rng).items():
        inp[f"grads/params/{k}"] = v
    for k in ("tokens", "labels"):
        inp[f"grads/{k}"] = rng.integers(0, mcfg.vocab_size, size=(4, 8)).astype(np.int32)
    inp["trace/tokens"] = rng.integers(0, mcfg.vocab_size, size=(4, 8)).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, the port's four ranks' outputs by rank)."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = make_inputs(np.random.default_rng(0))
    in_path = str(tmp / "in.npz")
    np.savez(in_path, **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {"jax": subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, in_path, str(tmp / "jax.npz")], env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    wenv = dict(env, OMP_NUM_THREADS="1")
    for r in range(4):
        procs[r] = subprocess.Popen([sys.executable, WORKER, str(r), "4", str(tmp / "store"), in_path, str(tmp)],
                                    env=wenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    failed = []
    for name, p in procs.items():
        try:
            so, se = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} ran past {TIMEOUT_S} s")
        if p.returncode != 0:
            failed.append(f"{name} exit {p.returncode}\n{so[-2000:]}\n{se[-4000:]}")
    assert not failed, "\n".join(failed)
    ranks = {r: dict(np.load(str(tmp / f"rank{r}.npz"))) for r in range(4)}
    return inp, dict(np.load(str(tmp / "jax.npz"))), ranks


def by_rank(ranks: dict) -> dict:
    """(data index, model index) → the rank's outputs."""
    return {tuple(int(i) for i in out["mesh"]): out for out in ranks.values()}


def assemble(ranks: dict, key: str, path: str) -> np.ndarray:
    """A case's whole output from the ranks': rows by data index (each model
    rank's copy must be identical), and for the sequence path's kept masks
    the sequence by model index."""
    pos = by_rank(ranks)
    if path == "seq" and key.endswith("kept"):
        parts = []
        for dd in range(2):
            cols = [pos[(dd, m)][key].reshape(2, -1, pos[(dd, m)][key].shape[-1]) for m in range(2)]
            parts.append(np.concatenate(cols, axis=1))
        return np.concatenate(parts, axis=0)
    for dd in range(2):
        np.testing.assert_array_equal(pos[(dd, 0)][key], pos[(dd, 1)][key])
    return np.concatenate([pos[(dd, 0)][key] for dd in range(2)], axis=0)


def experts_of(inp: dict, x: np.ndarray):
    """(weights [T,k], ids [T,k], every expert's output [T,E,d]) of the
    whole input, by the router and the SwiGLU in fp32."""
    cfg = get_config(MOONSHOT).smoke()
    p = {k: torch.from_numpy(inp[f"moe/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    w, idx, _ = moe._router(cfg, p["router"], xt)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["w_gate"])) * torch.einsum(
        "td,edf->tef", xt, p["w_up"])
    return w, idx, torch.einsum("tef,efd->ted", h, p["w_down"])


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("path", PATHS)
def test_moe_ffn_matches_jax_shard_map(runs, path, cf):
    inp, jax_out, ranks = runs
    y = assemble(ranks, f"moe/{path}/{cf}/y", path)
    want = jax_out[f"moe/{path}/{cf}/y"]
    assert y.shape == want.shape
    assert np.max(np.abs(y - want)) <= 1e-5
    for out in ranks.values():
        aux, jaux = float(out[f"moe/{path}/{cf}/aux"]), float(jax_out[f"moe/{path}/{cf}/aux"])
        assert abs(aux - jaux) <= 1e-6 * abs(jaux)


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("path", PATHS)
def test_the_same_assignments_drop(runs, path, cf):
    """Each side equals the dense sum over the assignments the port kept.
    At the configured 1.25 the sequence path drops some; the decode paths
    size an expert's capacity by its shard's expected load, ceil(T·k·cf/ep),
    which with top_k·cf >= ep (2·1.25 >= 2) is at least T, so none can drop
    there; at 0.5 every path drops, at 8.0 none does."""
    inp, jax_out, ranks = runs
    kept = assemble(ranks, f"moe/{path}/{cf}/kept", path).reshape(-1, 2)
    x = inp[MOE_KEY[path]]
    w, idx, y_all = experts_of(inp, x)
    keep = torch.from_numpy(kept).to(w.dtype)
    want = torch.einsum("tk,tkd->td", w * keep, y_all[torch.arange(idx.shape[0])[:, None], idx]).numpy()
    assert np.max(np.abs(jax_out[f"moe/{path}/{cf}/y"].reshape(want.shape) - want)) <= 1e-5
    assert np.max(np.abs(assemble(ranks, f"moe/{path}/{cf}/y", path).reshape(want.shape) - want)) <= 1e-5
    dropped = int((~kept).sum())
    drops = cf == "cf05" or (cf == "cf" and path == "seq")
    assert (dropped > 0) if drops else (dropped == 0), dropped


@pytest.mark.parametrize("path", PATHS)
def test_expert_parallel_paths_match_the_dense_oracle(runs, path):
    inp, _, ranks = runs
    cfg = get_config(MOONSHOT).smoke()
    x = inp[MOE_KEY[path]]
    p = {k: torch.from_numpy(inp[f"moe/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    dense, _ = moe._moe_dense(cfg, p, torch.from_numpy(x.reshape(-1, x.shape[-1])))
    y = assemble(ranks, f"moe/{path}/cf8/y", path)
    assert np.max(np.abs(y.reshape(dense.shape) - dense.numpy())) < 2e-4


@pytest.mark.parametrize("path", PATHS)
def test_bf16_expert_parallel_paths_match_the_dense_oracle(runs, path):
    """bf16 weights and tokens (the sequence path moves them through
    ``all_to_all`` and ``all_gather`` as bytes, the 2-D path gathers them
    over "data", the decode paths psum them in fp32) against bf16
    ``_moe_dense`` on one rank, capacity 8.0."""
    inp, _, ranks = runs
    cfg = get_config(MOONSHOT).smoke()
    x = torch.from_numpy(inp[MOE_KEY[path]]).to(torch.bfloat16)
    p = {k: torch.from_numpy(inp[f"moe/{k}"]).to(torch.bfloat16) for k in ("router", "w_gate", "w_up", "w_down")}
    dense, _ = moe._moe_dense(cfg, p, x.reshape(-1, x.shape[-1]))
    ref = dense.float().numpy()
    y = assemble(ranks, f"moe_bf16/{path}/y", path).reshape(ref.shape)
    assert np.max(np.abs(y - ref)) <= BF16_REL * np.max(np.abs(ref))


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_16_bit_collectives_are_exact(runs, dtype):
    """``all_gather`` over "data" and ``all_to_all`` over "model" move the
    16-bit words unchanged; ``psum`` and the gather's backward (a summing
    reduce-scatter) equal the fp32 sum of two ranks' words rounded once."""
    _, _, ranks = runs
    dt = getattr(torch, dtype)
    pos = by_rank(ranks)
    got = {dm: {k.rsplit("/", 1)[1]: v for k, v in out.items() if k.startswith(f"half/{dtype}/")}
           for dm, out in pos.items()}

    def rounded(a):
        return torch.from_numpy(a).to(dt).float().numpy()

    for (dd, m), out in got.items():
        np.testing.assert_array_equal(out["gather"], np.concatenate([got[(j, m)]["x"] for j in range(2)]))
        np.testing.assert_array_equal(out["all_to_all"],
                                      np.concatenate([got[(dd, j)]["x"][2 * m : 2 * m + 2] for j in range(2)]))
        np.testing.assert_array_equal(out["psum"], rounded(got[(dd, 0)]["x"] + got[(dd, 1)]["x"]))
        go_sum = rounded(got[(0, m)]["go"] + got[(1, m)]["go"])
        np.testing.assert_array_equal(out["gather_grad"], go_sum[4 * dd : 4 * dd + 4])


@pytest.mark.parametrize("axis", ("data", "model"))
def test_compressed_mean(runs, axis):
    inp, jax_out, ranks = runs
    g = inp["cmean/g"].reshape(2, 2, -1)  # [data, model, n]
    bound = float(np.max(np.abs(g))) / 127.0 + 1e-6
    for (dd, m), out in by_rank(ranks).items():
        got = out[f"cmean/{axis}"]
        plain = g[:, m].mean(axis=0) if axis == "data" else g[dd].mean(axis=0)
        assert np.max(np.abs(got - plain)) <= bound
        want = jax_out[f"cmean/{axis}"][m if axis == "data" else dd]
        assert np.max(np.abs(got - want)) <= 1e-6


@pytest.fixture(scope="module")
def one_rank_losses(runs):
    """The port's one-rank step from the same state and batches, by
    compression."""
    inp = runs[0]
    cfg = get_config(STABLELM).smoke()
    out = {}
    for comp in (False, True):
        model = Model(cfg)
        tcfg = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100, grad_compression=comp)
        state = init_state(model, tcfg, torch.Generator().manual_seed(0))
        want = nested(inp, "train/params")

        def load(dst, src):
            for k in dst:
                load(dst[k], src[k]) if isinstance(dst[k], dict) else dst[k].copy_(src[k])

        load(state["params"], want)
        step = build_train_step(model, ShapeSpec("t", "train", 16, 4), tcfg, "cpu")
        hist = []
        for i in range(STEPS):
            state, m = step(state, {k: torch.from_numpy(inp[f"train/batch{i}/{k}"]) for k in ("tokens", "labels")})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        out[comp] = np.array(hist)
    return out


@pytest.mark.parametrize("tag", TRAIN_TAGS)
def test_sharded_step_tracks_the_one_rank_and_jax_steps(runs, one_rank_losses, tag):
    _, jax_out, ranks = runs
    comp = tag.endswith("int8")
    jax_hist = jax_out[f"train/{'int8' if comp else 'plain'}/hist"]
    for out in ranks.values():
        hist = out[f"train/{tag}/hist"]
        assert np.max(np.abs(hist[:, 0] - one_rank_losses[comp][:, 0])) <= 1e-4
        assert np.max(np.abs(hist[:, 0] - jax_hist[:, 0])) <= 1e-4
        assert np.max(np.abs(hist[:, 1] - jax_hist[:, 1]) / jax_hist[:, 1]) <= 1e-4


@pytest.mark.parametrize("mode", ("tp", "fsdp"))
def test_each_rank_holds_its_blocks(runs, mode):
    """Every parameter and moment block has the shape of JAX's
    ``NamedSharding.shard_shape``; some leaves are split, and the step's
    bytes are the rank's share of the state."""
    _, jax_out, ranks = runs
    keys = [k[len(f"shard/{mode}/"):] for k in jax_out if k.startswith(f"shard/{mode}/")]
    assert keys
    split = 0
    for out in ranks.values():
        total = 0
        for key in keys:
            want = jax_out[f"shard/{mode}/{key}"]
            for part in ("params", "mu"):
                np.testing.assert_array_equal(out[f"train/{mode}/shape/{part}/{key}"], want)
            total += 3 * 4 * int(np.prod(want))
        split += sum(1 for key in keys if not np.array_equal(out[f"train/{mode}/shape/params/{key}"],
                                                                  runs[0][f"train/params/{key}"].shape))
        assert int(out[f"train/{mode}/bytes"]) == total + 4  # + the int32 count
    assert split > 0


def test_meshed_gradients_match_one_device(runs):
    """Cross-entropy gradients through the MoE ``forward_train`` on the mesh
    (sequence path, capacity 8.0) against the one-device path."""
    inp, _, ranks = runs
    base = get_config(MOONSHOT).smoke()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    params = nested(inp, "grads/params")
    batch = {k: torch.from_numpy(inp[f"grads/{k}"]) for k in ("tokens", "labels")}

    class CeOnly:
        def loss(self, p, b):
            return Model(cfg).loss(p, b)[1]["ce"], {}

    _, grads, _ = loss_and_grads(CeOnly(), params, batch)
    from repro_torch import tree

    for key, g in tree.items(grads):
        for out in ranks.values():
            got = out[f"grads/g/{key}"]
            scale = max(float(g.abs().max()), 1e-12)
            assert np.max(np.abs(got - g.numpy())) <= 1e-5 * scale + 1e-8, key


def test_collective_spans_of_a_meshed_prefill_and_decode(runs):
    """Per layer, the prefill's sequence path records three all-to-alls, one
    all-gather and the aux mean's two all-reduces; the decode step's
    replicated path a psum and the aux mean's two."""
    _, _, ranks = runs
    L = get_config(MOONSHOT).smoke().num_layers
    for out in ranks.values():
        coll = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items() if k.startswith("trace/ust_collective/")}
        assert coll == {"all_to_all": 3 * L, "all_gather": L, "all_reduce": 2 * L + 3 * L}
        assert int(out["trace/ust_kernel/flash_attention"]) == L


@pytest.mark.parametrize("mode", ("tp", "fsdp"))
def test_dtensor_placements_rebuild_every_leaf(runs, mode):
    """``Partitioner.placements`` on the device-backed mesh: a DTensor of
    each rank's block with them is the whole leaf, and the sharded leaves
    have a ``Shard`` per mesh axis that splits them."""
    _, jax_out, ranks = runs
    for out in ranks.values():
        rows = {k: v for k, v in out.items() if k.startswith(f"train/{mode}/dtensor/")}
        assert rows
        for key, (equal, n, shards) in rows.items():
            assert equal and n == 2, key
            want = jax_out[f"shard/{mode}/{key.split('/dtensor/', 1)[1]}"]
            full = runs[0][f"train/params/{key.split('/dtensor/', 1)[1]}"].shape
            split = int(np.prod(full) // np.prod(want))
            assert 2 ** shards == split, key
