"""PyTorch port, dense transformer and serving engine against the JAX package.

The JAX smoke models' weights (``Model.init(PRNGKey(0))``) are carried across
with ``repro_torch.convert``, so both packages compute the same function; on
the CPU the port's prefill attention runs ``ref.flash_attention_ref`` (the
kernel's plain version) and the JAX one its materialized ``attend``.  The
danube smoke window is 16: ``cache_len`` 32 keeps a ring of 16 rows and
``cache_len`` 8 a ring of 8, shorter than the window, and prompts of 5, 16,
23 and 32 tokens fall short of, fill, overrun and double each.  stablelm-3b
brings the LayerNorm and MHA, qwen1.5-32b the QKV bias.  fp32 throughout,
tolerance 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.models import Model as JaxModel
from repro.models.param import is_spec
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.param import Spec
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
DANUBE = "h2o-danube-1.8b"
DENSE = (DANUBE, "stablelm-3b", "qwen1.5-32b", "mistral-large-123b")


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(JAX model, JAX params, port model, port params) — same weights."""
    jm = JaxModel(jax_get_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def np32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def assert_trees_close(got, want, **tol):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        assert tuple(g[path].shape) == tuple(np.shape(w[path])), path
        np.testing.assert_allclose(np32(g[path]), np32(w[path]), err_msg=str(path), **tol)


def assert_specs_equal(got_tree, want_tree):
    want = jax.tree_util.tree_flatten_with_path(want_tree, is_leaf=is_spec)[0]
    got = dict(leaves(got_tree))
    assert len(got) == len(want)
    for path, spec in want:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        assert isinstance(got[key], Spec)
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(spec), key


@pytest.mark.parametrize("arch", DENSE)
def test_spec_trees_match_jax_leaf_by_leaf(arch):
    """Parameters and the serving cache, for each dense config's smoke
    reduction (specs only: no weights are drawn)."""
    jcfg, tcfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm, tm = JaxModel(jcfg), Model(tcfg)
    assert_specs_equal(tm.param_specs(), jm.param_specs())
    for cache_len in (8, 64):
        shape = ShapeSpec("serve", "decode", cache_len, 2)
        assert_specs_equal(tm.cache_specs(shape), jm.cache_specs(shape))


def test_parameter_count_of_the_spec_tree():
    """h2o-danube-1.8b at full width, from the shapes alone: the formula
    leaves out ln_f's d_model gains."""
    cfg = get_config(DANUBE)
    n = sum(int(np.prod(s.shape)) for _, s in leaves(Model(cfg).param_specs()))
    assert n == 1_831_201_280
    assert cfg.num_params() == 1_831_198_720 and n - cfg.num_params() == cfg.d_model


@pytest.mark.parametrize("cache_len", [32, 8])
@pytest.mark.parametrize("S", [5, 16, 23, 32])
def test_danube_prefill_and_decode_match_jax(S, cache_len):
    jm, jp, tm, tp = pair(DANUBE)
    assert jm.cfg.sliding_window == 16
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, cache_len)
    assert tc["k"].shape[2] == min(cache_len, 16)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    assert tc["len"].dtype == torch.int32
    for _ in range(3):  # past the ring's end once S >= eff
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        assert_trees_close(tc, jc, **TOL)


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen1.5-32b"])
def test_layernorm_and_qkv_bias_models_match_jax(arch):
    jm, jp, tm, tp = pair(arch)
    assert (jm.cfg.norm, jm.cfg.qkv_bias) == (("layernorm", False) if arch == "stablelm-3b" else ("rmsnorm", True))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, 16)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    for _ in range(2):
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        assert_trees_close(tc, jc, **TOL)


def test_decode_from_a_converted_jax_cache():
    """convert.py carries the dense cache (k, v, len) across unchanged."""
    jm, jp, tm, tp = pair(DANUBE)
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, size=(1, 23)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    assert sorted(tc) == ["k", "len", "v"]
    tok = np.array([7], np.int32)
    jl, _ = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
    tl, _ = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)


def serve_prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, size=(S,)) for S in (5, 16, 23, 9)]


SERVE = dict(batch_slots=2, cache_len=32, max_new_tokens=4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One traced serving run of the danube smoke model per package (default
    mode), same weights and prompts."""
    jm, jp, tm, tp = pair(DANUBE)
    out = {}
    for name, (Tr, Cfg, Eng, SCfg, model, params) in {
        "jax": (JaxTracer, JaxTraceConfig, JaxServeEngine, JaxServeConfig, jm, jp),
        "torch": (Tracer, TraceConfig, ServeEngine, ServeConfig, tm, tp),
    }.items():
        d = str(tmp_path_factory.mktemp(f"dense_{name}"))
        eng = Eng(model, params, SCfg(**SERVE))
        reqs = [eng.submit(p) for p in serve_prompts(model.cfg.vocab_size)]
        with Tr(Cfg(out_dir=d, mode="default")):
            eng.run_until_drained()
        out[name] = (d, [r.out_tokens for r in reqs])
    return out


def test_serving_matches_jax_greedy_tokens(served):
    (_, jtoks), (_, ttoks) = served["jax"], served["torch"]
    assert ttoks == jtoks
    assert all(len(t) == SERVE["max_new_tokens"] for t in ttoks)


def test_traced_serving_tallies_under_the_jax_package(served):
    d, _ = served["torch"]
    jt, tt = jax_tally_trace(d), tally_trace(d)
    assert jt.to_obj()["apis"] == tt.to_obj()["apis"]
    assert jt.to_obj()["device_apis"] == tt.to_obj()["device_apis"]


def test_traced_serving_rows_against_the_jax_run(served):
    """Framework rows equal the JAX run's in count.  The port's prefill
    attention is a kernel, one ``flash_attention`` row per layer and
    prefill; the JAX dense model's attention is plain jnp ``attend``, so
    its trace has no such row."""
    jt, tt = jax_tally_trace(served["jax"][0]), tally_trace(served["torch"][0])
    for api in ("prefill", "decode_step"):
        assert tt.apis[("ust_repro", api)].calls == jt.apis[("ust_repro", api)].calls
    prefills = tt.apis[("ust_repro", "prefill")].calls
    assert prefills == 4
    L = get_config(DANUBE).smoke().num_layers
    assert tt.device_apis[("ust_kernel", "flash_attention")].calls == L * prefills
    assert ("ust_kernel", "flash_attention") not in jt.device_apis


def _plain_greedy(tm, tp, prompt, cache_len, n):
    logits, cache = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, cache_len)
    toks = [int(torch.argmax(logits[0, 0, : tm.cfg.vocab_size]))]
    for _ in range(n - 1):
        logits, cache = tm.decode_step(tp, cache, {"token": torch.tensor([toks[-1]])})
        toks.append(int(torch.argmax(logits[0, 0, : tm.cfg.vocab_size])))
    return toks


@pytest.mark.parametrize("slots,cache_len", [(1, 32), (2, 8)])
def test_engine_serves_what_plain_prefill_and_decode_give(slots, cache_len):
    """One slot: the prefill row has the cache's own shape and is copied
    whole (the JAX engine's one-slot splice writes one element).  A
    cache_len under the window: an 8-row ring."""
    _, _, tm, tp = pair(DANUBE)
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=slots, cache_len=cache_len, max_new_tokens=4))
    prompts = serve_prompts(tm.cfg.vocab_size)[:3]
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    assert [r.out_tokens for r in reqs] == [_plain_greedy(tm, tp, p, cache_len, 4) for p in prompts]


def test_launcher_serves_danube_on_the_cpu(tmp_path, capsys):
    before = flash_attention.launches
    rc = serve_launcher.main(
        ["--arch", DANUBE, "--device", "cpu", "--requests", "3", "--new-tokens", "3",
         "--trace", "default", "--trace-dir", str(tmp_path)]
    )
    out = capsys.readouterr().out
    assert rc == 0 and flash_attention.launches == before
    assert "served 3 requests, 9 tokens" in out and "h2o-danube-1.8b-smoke" in out
    L = get_config(DANUBE).smoke().num_layers
    assert tally_trace(str(tmp_path)).device_apis[("ust_kernel", "flash_attention")].calls == 3 * L


def test_launcher_refuses_to_serve_danube_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launcher.main(["--arch", DANUBE])
