"""PyTorch port, Mixture-of-Experts model and serving engine against the JAX package.

The JAX smoke models' weights (``Model.init(PRNGKey(0))``) are carried across
with ``repro_torch.convert``, so both packages compute the same function: on
one device the JAX ``moe_ffn`` runs ``_moe_dense`` (every expert on every
token, masked top-k combine), which the port computes with batched matmuls
over the expert axis.  The port's prefill attention runs
``ref.flash_attention_ref`` on the CPU.  The smoke reduction has 8 experts,
top-2.  ``jax.lax.top_k`` and ``torch.topk`` break exact ties differently,
so the router cases assert equal top-k sets and report the smallest gap
between the k-th and (k+1)-th probability, which must exceed the two
packages' difference in the probabilities.  fp32 throughout, tolerance 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.models import Model, ShapeSpec, moe, param
from repro_torch.serve import ServeConfig, ServeEngine
from test_torch_dense_serve import assert_specs_equal, assert_trees_close, leaves, np32

TOL = dict(rtol=1e-4, atol=1e-4)
MOONSHOT = "moonshot-v1-16b-a3b"
MOE = (MOONSHOT, "kimi-k2-1t-a32b")


def _pair(arch):
    """(JAX model, JAX params, port model, port params) — same weights."""
    jm = JaxModel(jax_get_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _pair(MOONSHOT)


def _expert_inputs(cfg, T, seed):
    """Router and expert weights of one layer and T tokens, from a numpy seed."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    p = {
        "router": rng.normal(0, 0.3, (d, E)),
        "w_gate": rng.normal(0, 0.1, (E, d, f)),
        "w_up": rng.normal(0, 0.1, (E, d, f)),
        "w_down": rng.normal(0, 0.1, (E, f, d)),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.normal(size=(T, d)).astype(np.float32)


@pytest.mark.parametrize("T", [1, 4, 23])
def test_router_and_dense_experts_match_jax(T):
    cfg = get_config(MOONSHOT).smoke()
    jcfg = jax_get_config(MOONSHOT).smoke()
    p, x = _expert_inputs(cfg, T, seed=T)
    jw, jidx, jaux = jax_moe._router(jcfg, jnp.asarray(p["router"]), jnp.asarray(x))
    tw, tidx, taux = moe._router(cfg, torch.as_tensor(p["router"]), torch.as_tensor(x))
    probs = np.sort(np.asarray(jax.nn.softmax(x @ p["router"], axis=-1)), axis=-1)[:, ::-1]
    k = cfg.moe.top_k
    assert (probs[:, k - 1] - probs[:, k]).min() > 1e-5  # no near tie among these tokens
    assert [sorted(r) for r in tidx.tolist()] == [sorted(r) for r in np.asarray(jidx).tolist()]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))  # both descending
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    jout, jaux2 = jax_moe._moe_dense(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tout, taux2 = moe._moe_dense(cfg, {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x))
    assert tout.shape == (T, cfg.d_model)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux2), float(jaux2), **TOL)


def test_expert_products_copy_no_expert_weights():
    """No copy or clone in ``_moe_dense`` takes a ``[E, d, f]`` weight (an
    einsum over "td,edf->tef" copies one)."""
    cfg = get_config(MOONSHOT).smoke()
    p, x = _expert_inputs(cfg, 16, seed=0)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        moe._moe_dense(cfg, tp, torch.as_tensor(x))
    weight_shapes = {list(tp[k].shape).__repr__() for k in ("w_gate", "w_up", "w_down")}
    copies = [e for e in prof.events() if e.name in ("aten::copy_", "aten::clone", "aten::contiguous")]
    assert not [e for e in copies if any(repr(list(s)) in weight_shapes for s in e.input_shapes)]
    assert any(e.name == "aten::bmm" for e in prof.events())


@pytest.mark.parametrize("B,S", [(1, 5), (2, 3)])
def test_moe_ffn_is_the_jax_mesh_free_path(B, S):
    """``moe_ffn`` over ``[B, S, d]`` equals the JAX ``moe_ffn`` with no mesh
    (its ``_moe_dense`` path), output and aux loss."""
    cfg = get_config(MOONSHOT).smoke()
    p, x = _expert_inputs(cfg, B * S, seed=B * S)
    x = x.reshape(B, S, cfg.d_model)
    jout, jaux = jax_moe.moe_ffn(jax_get_config(MOONSHOT).smoke(), {k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), None)
    tout, taux = moe.moe_ffn(cfg, {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x))
    assert tout.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_spec_trees_match_jax_leaf_by_leaf(arch):
    jm, tm = JaxModel(jax_get_config(arch).smoke()), Model(get_config(arch).smoke())
    assert_specs_equal(tm.param_specs(), jm.param_specs())
    for cache_len in (8, 64):
        shape = ShapeSpec("serve", "decode", cache_len, 2)
        assert_specs_equal(tm.cache_specs(shape), jm.cache_specs(shape))


def test_parameter_count_of_the_spec_tree():
    """moonshot-v1-16b-a3b at full width, from the shapes alone: the
    formula leaves out ln_f's d_model gains."""
    cfg = get_config(MOONSHOT)
    n = sum(int(np.prod(s.shape)) for _, s in leaves(Model(cfg).param_specs()))
    assert n == 28_057_995_264
    assert n - cfg.num_params() == cfg.d_model == 2_048
    assert cfg.active_params() < cfg.num_params()


def test_init_draws_one_layer_at_a_time(monkeypatch):
    """A leaf stacked over layers is filled one layer's draw at a time, in
    the model dtype: the largest fp32 draw is one layer of the largest leaf."""
    cfg = dataclasses.replace(get_config(MOONSHOT).smoke(), dtype="bfloat16")
    drawn = []
    real = param._draw
    monkeypatch.setattr(param, "_draw", lambda s, shape, gen: drawn.append(shape) or real(s, shape, gen))
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    w = params["blocks"]["w_gate"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (cfg.num_layers, 8, cfg.d_model, 32)
    assert drawn.count(tuple(w.shape[1:])) == 2 * cfg.num_layers  # w_gate and w_up
    assert drawn.count((8, 32, cfg.d_model)) == cfg.num_layers  # w_down
    assert max(int(np.prod(s)) for s in drawn) == max(w[0].numel(), cfg.padded_vocab * cfg.d_model)
    assert bool((w[0] != w[1]).any())  # each layer its own draw


@pytest.mark.parametrize("S", [5, 16, 23])
def test_prefill_and_decode_match_jax(pair, S):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, 32)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    assert tc["len"].dtype == torch.int32
    for _ in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, out = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        assert out is tc
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        assert_trees_close(tc, jc, **TOL)


def test_decode_from_a_converted_jax_cache(pair):
    jm, jp, tm, tp = pair
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
def served(pair, tmp_path_factory):
    """One traced serving run of the moonshot smoke model per package
    (default mode), same weights and prompts."""
    jm, jp, tm, tp = pair
    out = {}
    for name, (Tr, Cfg, Eng, SCfg, model, params) in {
        "jax": (JaxTracer, JaxTraceConfig, JaxServeEngine, JaxServeConfig, jm, jp),
        "torch": (Tracer, TraceConfig, ServeEngine, ServeConfig, tm, tp),
    }.items():
        d = str(tmp_path_factory.mktemp(f"moe_{name}"))
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
    L = get_config(MOONSHOT).smoke().num_layers
    prefills = tt.apis[("ust_repro", "prefill")].calls
    assert prefills == 4 and tt.device_apis[("ust_kernel", "flash_attention")].calls == L * prefills


def _jax_greedy(jm, jp, prompt, cache_len, n):
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None].astype(np.int32))}, cache_len)
    toks = [int(jnp.argmax(logits[0, 0, : jm.cfg.vocab_size]))]
    for _ in range(n - 1):
        logits, cache = jm.decode_step(jp, cache, {"token": jnp.asarray([toks[-1]], jnp.int32)})
        toks.append(int(jnp.argmax(logits[0, 0, : jm.cfg.vocab_size])))
    return toks


def test_one_slot_engine_serves_the_jax_models_greedy_tokens(pair):
    """One slot: the JAX engine's splice writes one element over layer 0 of
    each cache leaf (ROADMAP fault 1), so the port's engine is held to the
    JAX model's own prefill and decode steps."""
    jm, jp, tm, tp = pair
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=1, cache_len=32, max_new_tokens=4))
    prompts = serve_prompts(tm.cfg.vocab_size)[:3]
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    assert [r.out_tokens for r in reqs] == [_jax_greedy(jm, jp, p, 32, 4) for p in prompts]
