"""PyTorch port, RecurrentGemma hybrid model and serving engine against the
JAX package.

The JAX smoke model's weights (``Model.init(PRNGKey(0))``) are carried across
with ``repro_torch.convert``, so both packages compute the same function; on
the CPU both run their plain RG-LRU versions.  Two configurations: the smoke
config (6 layers: two (rec, rec, attn) groups, no tail) and an 8-layer
variant whose 2-block tail is the ``tail`` list.  The smoke window is 16, so
``cache_len`` 16 puts the attention ring at the window and prompts of 10,
16, 23 and 32 tokens cover S < eff, S == eff, S > eff and S a multiple of
eff.  fp32 throughout, tolerance 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.models import Model as JaxModel
from repro.models.param import is_spec
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.models import Model, hybrid
from repro_torch.models.param import Spec
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "recurrentgemma-2b"
CACHE_LEN = 16  # the smoke window: the ring holds 16 positions
LAYERS = {"smoke": 6, "tail": 8}


def _cfg(getter, variant):
    return dataclasses.replace(getter(ARCH).smoke(), num_layers=LAYERS[variant])


@functools.lru_cache(maxsize=None)
def pair(variant, dtype="float32"):
    """(JAX model, JAX params, port model, port params) — same weights."""
    jm = JaxModel(dataclasses.replace(_cfg(jax_get_config, variant), dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(_cfg(get_config, variant), dtype=dtype))
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


@pytest.mark.parametrize("variant", ["smoke", "tail"])
def test_spec_tree_matches_jax_leaf_by_leaf(variant):
    jm, jp, tm, tp = pair(variant)
    _, g, rem = hybrid.layout(tm.cfg)
    assert (g, len(rem)) == ((2, 0) if variant == "smoke" else (2, 2))
    want = jax.tree_util.tree_flatten_with_path(jm.param_specs(), is_leaf=is_spec)[0]
    got = dict(leaves(tm.param_specs()))
    assert len(got) == len(want)
    for path, spec in want:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        assert isinstance(got[key], Spec)
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(spec), key
    # and the carried-across weights have the declared shapes, lists included
    assert isinstance(tp["tail"], list) and len(tp["tail"]) == len(rem)
    for path, leaf in leaves(tp):
        assert tuple(leaf.shape) == got[path].shape


def test_init_draws_lists_and_the_lru_a_range_from_the_generator():
    m = Model(_cfg(get_config, "tail"))
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a), leaves(b)))
    assert len(a["tail"]) == 2
    for lam in (a["groups"]["b0_rec"]["rec"]["lam"], a["tail"][1]["rec"]["lam"]):
        decay = torch.exp(-8.0 * torch.nn.functional.softplus(lam))  # a at σ(r) = 1
        assert bool(((decay >= 0.9 - 1e-5) & (decay <= 0.999 + 1e-5)).all())


def test_parameter_count_of_the_spec_tree():
    """The spec tree of the full config allocates one d_model norm more than
    the reference formula counts."""
    cfg = get_config(ARCH)
    n = sum(int(np.prod(s.shape)) for _, s in leaves(Model(cfg).param_specs()))
    assert n == 2_682_191_360
    assert n - cfg.num_params() == cfg.d_model


@pytest.mark.parametrize("variant", ["smoke", "tail"])
@pytest.mark.parametrize("S", [10, 16, 23, 32])
def test_prefill_and_decode_match_jax(variant, S):
    jm, jp, tm, tp = pair(variant)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, CACHE_LEN)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    assert tc["len"].dtype == torch.int32
    for _ in range(3):  # S >= 16 decodes past the ring's end
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        assert_trees_close(tc, jc, **TOL)


@pytest.mark.parametrize("variant", ["smoke", "tail"])
@pytest.mark.parametrize("S", [8, 20])
def test_decode_continues_prefill(variant, S):
    """Prefill over S tokens equals prefill over S-1 and one decode step of
    the last, also once the ring has wrapped (S=20 > window 16)."""
    _, _, tm, tp = pair(variant)
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, tm.cfg.vocab_size, size=(2, S)))
    full_logits, _ = tm.prefill(tp, {"tokens": toks}, CACHE_LEN)
    _, cache = tm.prefill(tp, {"tokens": toks[:, :-1]}, CACHE_LEN)
    step_logits, _ = tm.decode_step(tp, cache, {"token": toks[:, -1]})
    np.testing.assert_allclose(np32(full_logits[:, 0]), np32(step_logits[:, 0]), rtol=2e-4, atol=2e-4)


def test_decode_from_a_converted_jax_cache():
    jm, jp, tm, tp = pair("tail")
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, size=(1, 23)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    assert isinstance(tc["tail"], list)
    tok = np.array([7], np.int32)
    jl, _ = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
    tl, _ = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)


def _dtypes(tree):
    return {path: str(np.dtype(leaf.dtype)) if not isinstance(leaf, torch.Tensor)
            else str(leaf.dtype).replace("torch.", "") for path, leaf in leaves(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_leaf_dtypes_follow_jax_through_prefill_splice_and_decode(dtype):
    """The recurrent state ``h`` leaves the RG-LRU in fp32: the splice rounds
    it into the bf16 cache leaf, and the first decode step makes it fp32."""
    jm, jp, tm, tp = pair("tail", dtype)
    cfg = dict(batch_slots=2, cache_len=CACHE_LEN, max_new_tokens=4)
    je, te = JaxServeEngine(jm, jp, JaxServeConfig(**cfg)), ServeEngine(tm, tp, ServeConfig(**cfg))
    prompt = np.arange(10) % jm.cfg.vocab_size
    toks = prompt[None].astype(np.int32)
    _, jrow = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    _, trow = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, CACHE_LEN)
    assert _dtypes(trow) == _dtypes(jrow)
    assert _dtypes(trow)[("tail", 0, "h")] == "float32"
    for e in (je, te):
        e.submit(prompt)
        e._fill_slots()
    assert _dtypes(te.cache) == _dtypes(je.cache)
    assert _dtypes(te.cache)[("groups", "b0_rec", "h")] == dtype
    je.step()
    te.step()
    assert _dtypes(te.cache) == _dtypes(je.cache)
    assert _dtypes(te.cache)[("groups", "b0_rec", "h")] == "float32"
    assert _dtypes(te.cache)[("groups", "b2_attn", "k")] == dtype


def serve_prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, size=(S,)) for S in (10, 16, 23, 32)]


@pytest.mark.parametrize("variant", ["smoke", "tail"])
def test_serving_matches_jax_greedy_tokens(variant):
    jm, jp, tm, tp = pair(variant)
    cfg = dict(batch_slots=2, cache_len=CACHE_LEN, max_new_tokens=5)
    je = JaxServeEngine(jm, jp, JaxServeConfig(**cfg))
    te = ServeEngine(tm, tp, ServeConfig(**cfg))
    prompts = serve_prompts(jm.cfg.vocab_size)
    jr = [je.submit(p) for p in prompts]
    tr = [te.submit(p) for p in prompts]
    je.run_until_drained()
    te.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(len(r.out_tokens) == 5 for r in tr)


def _plain_greedy(tm, tp, prompt, cache_len, n):
    logits, cache = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, cache_len)
    toks = [int(torch.argmax(logits[0, 0, : tm.cfg.vocab_size]))]
    for _ in range(n - 1):
        logits, cache = tm.decode_step(tp, cache, {"token": torch.tensor([toks[-1]])})
        toks.append(int(torch.argmax(logits[0, 0, : tm.cfg.vocab_size])))
    return toks


@pytest.mark.parametrize("slots,cache_len", [(1, CACHE_LEN), (2, 8)])
def test_engine_serves_what_plain_prefill_and_decode_give(slots, cache_len):
    """One slot: the row has the cache's own shape and is copied whole, at
    every leaf.  A cache_len under the window: the ring is cache_len rows,
    where the JAX engine's window-sized ring cannot take the prefill row."""
    _, _, tm, tp = pair("tail")
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=slots, cache_len=cache_len, max_new_tokens=4))
    prompts = serve_prompts(tm.cfg.vocab_size)[:2]
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    assert [r.out_tokens for r in reqs] == [_plain_greedy(tm, tp, p, cache_len, 4) for p in prompts]


def test_engine_is_freed_without_the_garbage_collector():
    """No reference cycle holds a served engine (and so its cache and model)
    alive: dropping the last reference frees it with the collector off."""
    import gc
    import weakref

    _, _, tm, tp = pair("smoke")
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=2, cache_len=CACHE_LEN, max_new_tokens=2))
    for p in serve_prompts(tm.cfg.vocab_size)[:2]:
        eng.submit(p)
    eng.run_until_drained()
    assert eng._prefill_steps
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_traced_serving_tallies_under_the_jax_package(tmp_path):
    """A default-mode trace of the port's hybrid serving tallies alike under
    the JAX ``tally_trace`` and the port's, with one ``rglru_scan`` row per
    recurrent block per prefill and per decode step."""
    _, _, tm, tp = pair("tail")
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=2, cache_len=CACHE_LEN, max_new_tokens=3))
    for p in serve_prompts(tm.cfg.vocab_size):
        eng.submit(p)
    with Tracer(TraceConfig(out_dir=str(tmp_path), mode="default")):
        eng.run_until_drained()
    jt, tt = jax_tally_trace(str(tmp_path)), tally_trace(str(tmp_path))
    assert jt.to_obj()["apis"] == tt.to_obj()["apis"]
    prefills = jt.apis[("ust_repro", "prefill")].calls
    steps = jt.apis[("ust_repro", "decode_step")].calls
    assert prefills == 4 and steps > 0
    n_rec = tm.cfg.block_counts()[1]
    assert n_rec == 6
    assert jt.device_apis[("ust_kernel", "rglru_scan")].calls == n_rec * (prefills + steps)


def test_launcher_serves_the_hybrid_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as serve_launcher

    rc = serve_launcher.main(
        ["--arch", ARCH, "--device", "cpu", "--requests", "3", "--new-tokens", "3",
         "--trace", "default", "--trace-dir", str(tmp_path)]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 3 requests, 9 tokens" in out and "recurrentgemma-2b-smoke" in out
    n_rec = get_config(ARCH).smoke().block_counts()[1]
    launches = tally_trace(str(tmp_path)).device_apis[("ust_kernel", "rglru_scan")].calls
    assert launches > 0 and launches % n_rec == 0
