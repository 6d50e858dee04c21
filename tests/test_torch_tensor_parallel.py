"""Tensor-parallel compute over the "model" axis: the port's four ``gloo``
CPU ranks on the 1x4 and 2x2 ``("data", "model")`` meshes against the JAX
package on four fake XLA host devices and against the port's one-rank step
and engine.

One module fixture writes numpy inputs (one seed), then runs at once the
JAX side in a subprocess per mesh (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
and the four ranks of ``tests/torch_tp_worker.py`` (a ``FileStore`` under
``tmp_path``), each with its own time limit.  The configs are the danube and
moonshot smoke configs (4 heads of 16; danube 2 KV heads, so 1x4 splits the
query heads and keeps the KV heads whole, and 2x2 splits both; moonshot at
capacity 8.0, where no assignment drops, with no aux term, so its loss is
the cross-entropy the one-rank step computes).  All comparisons in fp32:

* the sharded step's loss and every gradient within 1e-5 (of the largest
  gradient of the leaf) of the one-rank port step and of JAX's gradient
  under the same mesh's shardings; five steps' losses within 1e-4 of both;
* the meshed engine's greedy tokens identical to the JAX ``ServeEngine``
  with a ``Partitioner`` on the same mesh, its prefill and decode logits
  within 1e-4 of JAX's;
* each rank's cache block within 1e-5 of ``local_block`` of the one-rank
  engine's cache after the same schedule, and the KV leaves' blocks 1/4 of
  the whole on 2x2;
* each rank's counted matrix FLOPs of a forward exactly 1/(data*model) of
  the one-rank count for the split products (on 1x4 the K and V
  projections, whose two KV heads do not divide four ranks, are whole);
* a vocabulary split with padding (250 of 256 columns) and one that does
  not divide the axis (255) give the one-rank loss within 1e-5.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.launch.dryrun import Counter
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.param import Spec
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.train_step import TrainConfig, build_train_step, init_state, loss_and_grads

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(ROOT, "tests", "torch_tp_worker.py")
TIMEOUT_S = 300
DANUBE, MOONSHOT = "h2o-danube-1.8b", "moonshot-v1-16b-a3b"
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
#: name -> the smoke config and the fields replaced in it, and the worker's cases
CASES = {
    "danube": {"config": [DANUBE, {}], "kinds": ["grads", "train", "flops", "serve"]},
    "moonshot": {"config": [MOONSHOT, {"moe": {"capacity_factor": 8.0, "aux_loss_weight": 0.0}}],
                 "kinds": ["grads", "train"]},
    "padded": {"config": [DANUBE, {"vocab_size": 250}], "kinds": ["vocab"]},
    "odd": {"config": [DANUBE, {"vocab_size": 255, "vocab_multiple": 1}], "kinds": ["vocab"]},
}
STEPS = 5
PROMPT_LENS = (5, 9, 9, 5, 9)
SERVE = dict(batch_slots=4, cache_len=32, max_new_tokens=4)

JAX_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.jaxcompat import make_mesh
    from repro.models import Model, ShapeSpec
    from repro.optim import adamw_init
    from repro.models.param import axes as spec_axes, shapes as spec_shapes
    from repro.serve.artifacts import prefill_artifacts
    from repro.serve.engine import ServeConfig, ServeEngine
    from repro.sharding import Partitioner
    from repro.train.train_step import TrainConfig, _tree_pspecs, build_train_artifacts

    inp = np.load(sys.argv[1])
    cases, meshes, steps, serve = json.loads(sys.argv[3])
    out = {}

    def config(case):
        arch, fields = case
        cfg = get_config(arch).smoke()
        fields = dict(fields)
        moe = fields.pop("moe", None)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        return dataclasses.replace(cfg, **fields)

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

    def flat(t, prefix):
        if isinstance(t, dict):
            r = {}
            for k, v in t.items():
                r.update(flat(v, prefix + "/" + k))
            return r
        return {prefix: np.asarray(t)}

    def batch(name, i):
        return {k: jnp.asarray(inp[f"{name}/batch{i}/{k}"]) for k in ("tokens", "labels")}

    def entries(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def specs_of(shardings, prefix):
        leaves = jax.tree_util.tree_flatten_with_path(shardings)[0]
        return {prefix + "/".join(str(getattr(k, "key", k)) for k in path): json.dumps(entries(sh.spec))
                for path, sh in leaves}

    tc = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
    shape = ShapeSpec("tp", "train", 16, 4)
    prompts = [inp[k] for k in sorted(k for k in inp.files if k.startswith("serve/prompt"))]
    for tag, dims in meshes.items():
        mesh = make_mesh(tuple(dims), ("data", "model"))
        part = Partitioner(mesh)
        for name, case in cases.items():
            if "grads" not in case["kinds"]:
                continue
            cfg = config(case["config"])
            model = Model(cfg, mesh)
            shard = lambda ps: NamedSharding(mesh, ps)
            p_sh = jax.tree_util.tree_map(shard, _tree_pspecs(part, model.shapes(), model.axes()),
                                          is_leaf=lambda x: isinstance(x, P))
            b_sh = {"tokens": shard(P("data")), "labels": shard(P("data"))}
            params = jax.device_put(tree_of(f"{name}/params"), p_sh)
            with mesh:
                vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]), in_shardings=(p_sh, b_sh))
                loss, grads = vg(params, batch(name, 0))
                out[f"{tag}/{name}/loss"] = np.asarray(loss)
                out.update(flat(grads, f"{tag}/{name}/grad"))
                step, *_ = build_train_artifacts(model, part, shape, tc)
                state = {"params": params, "opt": adamw_init(params, tc.adamw)}
                hist = []
                for i in range(steps):
                    state, m = step(state, batch(name, i))
                    hist.append((float(m["loss"]), float(m["grad_norm"])))
                out[f"{tag}/{name}/hist"] = np.array(hist)
                if "serve" not in case["kinds"]:
                    continue
                pshape = ShapeSpec("p", "prefill", 16, 4)
                _, _, (pa_p, pa_b) = prefill_artifacts(model, part, pshape)
                c_specs = model.cache_specs(pshape)
                pa_c = jax.tree_util.tree_map(shard, _tree_pspecs(part, spec_shapes(c_specs, cfg.dtype),
                                                                  spec_axes(c_specs)), is_leaf=lambda x: isinstance(x, P))
                for kind, tree in (("params", pa_p), ("batch", pa_b), ("cache", pa_c)):
                    for key, v in specs_of(tree, f"{tag}/{name}/specs/{kind}/").items():
                        out[key] = np.array(v)
                params = jax.device_put(tree_of(f"{name}/params"), p_sh)  # the step donated the first
                eng = ServeEngine(model, params, ServeConfig(**serve), partitioner=part)
                log = {"prefill": [], "decode": []}
                decode = eng._decode

                def dec(*a, decode=decode, log=log):
                    o = decode(*a)
                    log["decode"].append(np.asarray(o[0]))
                    return o

                class Prefills(dict):
                    def __setitem__(self, key, fn, log=log):
                        def run(p, b):
                            o = fn(p, b)
                            log["prefill"].append(np.asarray(o[0]))
                            return o
                        super().__setitem__(key, run)

                eng._decode = dec
                eng._prefill_jits = Prefills()
                reqs = [eng.submit(p) for p in prompts]
                eng.run_until_drained()
            out[f"{tag}/{name}/serve/tokens"] = np.array([r.out_tokens for r in reqs])
            out[f"{tag}/{name}/serve/prefill"] = np.concatenate(log["prefill"])
            out[f"{tag}/{name}/serve/decode"] = np.stack(log["decode"])
    np.savez(sys.argv[2], **out)
    print("JAX_OK")
    """
)


def config(name: str):
    from torch_tp_worker import config as of

    return of(CASES[name]["config"])


def numpy_params(spec_tree, rng) -> dict:
    """A spec tree's leaves drawn with numpy (normal x scale, zeros, ones),
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

    walk(spec_tree, "")
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
    inp = {}
    for name in CASES:
        cfg = config(name)
        for k, v in numpy_params(Model(cfg).param_specs(), rng).items():
            inp[f"{name}/params/{k}"] = v
        for i in range(STEPS if name in ("danube", "moonshot") else 1):
            for k in ("tokens", "labels"):
                inp[f"{name}/batch{i}/{k}"] = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    vocab = config("danube").vocab_size
    for i, n in enumerate(PROMPT_LENS):
        inp[f"serve/prompt{i}"] = rng.integers(0, vocab, size=n).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, the four ranks' outputs by rank)."""
    tmp = tmp_path_factory.mktemp("tp")
    inp = make_inputs(np.random.default_rng(0))
    in_path = str(tmp / "in.npz")
    np.savez(in_path, **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for tag, dims in MESHES.items():  # XLA compiles on one core: a process per mesh
        args = json.dumps([CASES, {tag: dims}, STEPS, SERVE])
        procs[tag] = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, in_path, str(tmp / f"jax{tag}.npz"), args],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    wenv = dict(env, OMP_NUM_THREADS="1")
    for r in range(4):
        procs[r] = subprocess.Popen([sys.executable, WORKER, str(r), "4", str(tmp / "store"), in_path, str(tmp),
                                     json.dumps(CASES)],
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
    jax_out = {}
    for tag in MESHES:
        jax_out.update(np.load(str(tmp / f"jax{tag}.npz")))
    return inp, jax_out, ranks


def batch(inp, name: str, i: int) -> dict:
    return {k: torch.from_numpy(inp[f"{name}/batch{i}/{k}"]) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def one_rank(runs):
    """The port's one-rank loss, gradients, five steps and engine."""
    inp = runs[0]
    out = {}
    tcfg = TrainConfig(peak_lr=5e-3, warmup=2, total_steps=100)
    for name, case in CASES.items():
        cfg = config(name)
        model = Model(cfg)
        params = nested(inp, f"{name}/params")
        loss, grads, _ = loss_and_grads(model, params, batch(inp, name, 0))
        out[f"{name}/loss"] = float(loss)
        out[f"{name}/grads"] = dict(tree.items(grads))
        if "train" in case["kinds"]:
            state = init_state(model, tcfg, torch.Generator().manual_seed(0))
            tree.map(lambda dst, src: dst.copy_(src), state["params"], params)
            step = build_train_step(model, ShapeSpec("tp", "train", 16, 4), tcfg, "cpu")
            hist = []
            for i in range(STEPS):
                state, m = step(state, batch(inp, name, i))
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            out[f"{name}/hist"] = np.array(hist)
        if "flops" in case["kinds"]:
            with torch.no_grad(), Counter("cpu") as c:
                model.loss(params, batch(inp, name, 0))
            out[f"{name}/flops"] = c.flops
        if "serve" in case["kinds"]:
            eng = ServeEngine(model, params, ServeConfig(**SERVE))
            reqs = [eng.submit(inp[f"serve/prompt{i}"]) for i in range(len(PROMPT_LENS))]
            with torch.no_grad():
                eng.run_until_drained()
            out[f"{name}/tokens"] = np.array([r.out_tokens for r in reqs])
    return out


def by_mesh(ranks: dict, tag: str) -> dict:
    """(data index, model index) -> the rank's outputs on mesh ``tag``."""
    return {tuple(int(i) for i in out[f"{tag}/mesh"]): out for out in ranks.values()}


def _close(got, want, rel: float, what: str) -> None:
    scale = max(float(np.max(np.abs(want))), 1e-12)
    d = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert d <= rel * scale + 1e-8, f"{what}: max|d| {d:.3g} > {rel:g} x {scale:.3g}"


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", ("danube", "moonshot"))
def test_loss_and_every_gradient_match_one_rank_and_jax(runs, one_rank, name, tag):
    _, jax_out, ranks = runs
    keys = sorted(one_rank[f"{name}/grads"])
    assert keys
    for out in ranks.values():
        assert abs(float(out[f"{tag}/{name}/loss"]) - one_rank[f"{name}/loss"]) <= 1e-5
        assert abs(float(out[f"{tag}/{name}/loss"]) - float(jax_out[f"{tag}/{name}/loss"])) <= 1e-5
        for key in keys:
            got = out[f"{tag}/{name}/grad/{key}"]
            _close(got, one_rank[f"{name}/grads"][key].numpy(), 1e-5, f"{tag} {name} {key} against one rank")
            _close(got, jax_out[f"{tag}/{name}/grad/{key}"], 1e-5, f"{tag} {name} {key} against JAX")


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", ("danube", "moonshot"))
def test_five_steps_match_one_rank_and_jax(runs, one_rank, name, tag):
    _, jax_out, ranks = runs
    want, jax_hist = one_rank[f"{name}/hist"], jax_out[f"{tag}/{name}/hist"]
    for out in ranks.values():
        hist = out[f"{tag}/{name}/hist"]
        assert np.max(np.abs(hist[:, 0] - want[:, 0])) <= 1e-4
        assert np.max(np.abs(hist[:, 0] - jax_hist[:, 0])) <= 1e-4
        assert np.max(np.abs(hist[:, 1] - jax_hist[:, 1]) / jax_hist[:, 1]) <= 1e-4


@pytest.mark.parametrize("tag", MESHES)
def test_meshed_engine_matches_the_jax_engine(runs, one_rank, tag):
    _, jax_out, ranks = runs
    key = f"{tag}/danube/serve"
    for out in ranks.values():
        np.testing.assert_array_equal(out[f"{key}/tokens"], jax_out[f"{key}/tokens"])
        np.testing.assert_array_equal(out[f"{key}/tokens"], one_rank["danube/tokens"])
        for phase in ("prefill", "decode"):
            got, want = out[f"{key}/{phase}"], jax_out[f"{key}/{phase}"]
            assert got.shape == want.shape
            assert np.max(np.abs(got - want)) <= 1e-4, phase


@pytest.mark.parametrize("tag", MESHES)
def test_prefill_artifacts_specs_are_the_jax_shardings(runs, tag):
    """The parameter, batch and cache specs of ``artifacts.prefill_artifacts``
    under a ``tp`` partitioner are the JAX ``prefill_artifacts``' shardings,
    leaf for leaf (danube computes its KV heads locally, so its cache takes
    JAX's cache sharding as it is)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.artifacts import prefill_artifacts
    from repro_torch.sharding import Partitioner, spec_items

    _, jax_out, _ = runs
    dp, mp = MESHES[tag]
    got = prefill_artifacts(Model(config("danube")), Partitioner(Mesh({"data": dp, "model": mp})),
                            ShapeSpec("p", "prefill", 16, 4))
    for kind, specs in zip(("params", "batch", "cache"), got, strict=True):
        items = dict(spec_items(specs))
        want = {k.rsplit(f"/{kind}/", 1)[1]: json.loads(str(v)) for k, v in jax_out.items()
                if k.startswith(f"{tag}/danube/specs/{kind}/")}
        assert sorted(items) == sorted(want) and want, kind
        for key, spec in items.items():
            assert [list(e) if isinstance(e, tuple) else e for e in spec] == want[key], (kind, key)
    kv_split = config("danube").padded_kv_heads % mp == 0  # 2 KV heads: on 2x2, not on 1x4
    assert any("model" in s.mesh_axes() for _, s in spec_items(got[2])) == kv_split


@pytest.mark.parametrize("tag", MESHES)
def test_each_rank_holds_its_block_of_the_cache(runs, tag):
    """Within 1e-5 of ``local_block`` of the one-rank engine's cache; on 2x2
    a rank holds half the slots and half the KV heads, on 1x4 all the slots
    and, the two KV heads not dividing four ranks, all the heads."""
    _, _, ranks = runs
    share = {"1x4": 1, "2x2": 4}[tag]
    for out in ranks.values():
        for leaf in ("k", "v", "len"):
            d, n, whole = out[f"{tag}/danube/cache/{leaf}"]
            assert d <= 1e-5, (leaf, d)
            assert n * (share if leaf != "len" else {"1x4": 1, "2x2": 2}[tag]) == whole, leaf


@pytest.mark.parametrize("tag", MESHES)
def test_each_rank_counts_its_share_of_the_matrix_flops(runs, one_rank, tag):
    """Every product of the danube forward splits over data x model, but on
    1x4 the K and V projections: two KV heads do not divide four ranks, so
    each rank projects all of them for its rows."""
    _, _, ranks = runs
    cfg = config("danube")
    dp, mp = MESHES[tag]
    total = one_rank["danube/flops"]
    B, S = 4, 16
    kv = 2 * 2 * B * S * cfg.d_model * cfg.num_kv_heads * cfg.head_dim_ * cfg.num_layers
    whole_kv = cfg.num_kv_heads % mp != 0
    want = (total - kv) // (dp * mp) + (kv // dp if whole_kv else kv // (dp * mp))
    assert (total - kv) % (dp * mp) == 0
    for out in ranks.values():
        assert int(out[f"{tag}/danube/flops"]) == want


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("name", ("padded", "odd"))
def test_a_vocabulary_split_with_padding_or_not_split_gives_the_loss(runs, one_rank, name, tag):
    """250 real of 256 columns: split, the padding masked at its global
    index on the last rank; 255 columns: no "model" split divides them, so
    every rank holds the whole vocabulary."""
    _, _, ranks = runs
    cfg = config(name)
    split = cfg.padded_vocab % MESHES[tag][1] == 0
    for out in ranks.values():
        assert abs(float(out[f"{tag}/{name}/loss"]) - one_rank[f"{name}/loss"]) <= 1e-5
        block = int(out[f"{tag}/{name}/vocab_block"])
        assert block == (cfg.padded_vocab // MESHES[tag][1] if split else cfg.padded_vocab)


@pytest.mark.parametrize("name", ("danube", "moonshot"))
def test_a_model_computes_local_blocks_only_on_its_own_split_mesh(name):
    """Without a mesh, or on one whose "model" axis is one rank, a model
    gathers its heads, FFN columns and vocabulary whole (the MoE experts
    still reach it as blocks); ``on_mesh`` rebuilds it on the partitioner's
    mesh; a block that no mesh places raises instead of reading as whole."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.placement import BLOCK_AXES, TENSOR_PARALLEL, block_range

    cfg = config(name)
    experts = BLOCK_AXES if cfg.family == "moe" else ()
    tp, dp = Mesh({"data": 1, "model": 4}), Mesh({"data": 4, "model": 1})
    assert Model(cfg).keep_local == experts
    assert Model(cfg, dp).keep_local == experts
    assert Model(cfg, tp).keep_local == TENSOR_PARALLEL + experts
    alone = Model(cfg)
    assert alone.on_mesh(Mesh({"data": 1, "model": 1})) is alone
    on_tp = alone.on_mesh(tp)
    assert on_tp.mesh is tp and on_tp.keep_local == TENSOR_PARALLEL + experts
    assert on_tp.on_mesh(tp) is on_tp
    assert on_tp.on_mesh(dp).keep_local == experts
    assert block_range(cfg.padded_vocab, cfg.padded_vocab, None) == (0, cfg.padded_vocab)
    with pytest.raises(ValueError, match="no mesh"):
        block_range(cfg.padded_vocab, cfg.padded_vocab // 4, None)
