"""PyTorch port, encoder–decoder (whisper-medium) and VLM (llava-next-34b)
serving against the JAX package.

The JAX smoke models' weights (``Model.init(PRNGKey(0))``) are carried across
with ``repro_torch.convert``, so both packages compute the same function.
The whisper smoke model has 2 encoder and 4 decoder layers over 16 frames,
LayerNorm, the biased GELU MLP and tied embeddings; its frames are drawn
from a numpy seed, and the engine feeds zeros, as the JAX engine does.  On
the CPU the port's prefill attention (the encoder's, the decoder's causal
one and its cross attention) runs ``ref.flash_attention_ref``.  The llava
smoke model prepends 8 patch embeddings to the prompt; the JAX engine feeds
none, so the VLM runs through ``Model.prefill`` / ``decode_step`` only.
fp32 throughout, tolerance 1e-4.
"""

import dataclasses

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
from repro.models import layers as jax_layers
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.models import Model, ShapeSpec, layers
from repro_torch.serve import ServeConfig, ServeEngine
from test_torch_dense_serve import assert_specs_equal, assert_trees_close, leaves, np32
from test_torch_moe_serve import _jax_greedy, _pair, serve_prompts

TOL = dict(rtol=1e-4, atol=1e-4)
WHISPER = "whisper-medium"
LLAVA = "llava-next-34b"


@pytest.fixture(scope="module")
def whisper():
    return _pair(WHISPER)


@pytest.fixture(scope="module")
def llava():
    return _pair(LLAVA)


def test_gelu_mlp_with_biases_matches_jax():
    cfg = get_config(WHISPER).smoke()
    assert cfg.mlp_type == "gelu"
    rng = np.random.default_rng(0)
    specs = layers.mlp_specs(cfg)
    assert sorted(specs) == ["b_down", "b_up", "w_down", "w_up"]
    p = {k: rng.normal(0, 0.5, s.shape).astype(np.float32) for k, s in specs.items()}
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = jax_layers.apply_mlp(jax_get_config(WHISPER).smoke(), {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    got = layers.apply_mlp(cfg, {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_specs_match_jax(cross):
    """Cross attention has no QKV bias, even where the config has one."""
    tcfg = dataclasses.replace(get_config(WHISPER).smoke(), qkv_bias=True)
    jcfg = dataclasses.replace(jax_get_config(WHISPER).smoke(), qkv_bias=True)
    got = layers.attn_specs(tcfg, stacked=3, cross=cross)
    assert_specs_equal(got, jax_layers.attn_specs(jcfg, stacked=3, cross=cross))
    assert ("bq" in got) is not cross


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_qkv_without_rope_matches_jax(arch):
    """``qkv`` with no positions (whisper's encoder and decoder call it so)
    equals the JAX ``qkv(..., use_rope=False)``; with positions, its RoPE."""
    cfg = get_config(arch).smoke()
    rng = np.random.default_rng(1)
    p = {k: rng.normal(0, 0.3, s.shape).astype(np.float32) for k, s in layers.attn_specs(cfg).items()}
    x = rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32)
    pos = np.arange(6)[None]
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.as_tensor(v) for k, v in p.items()}
    jcfg = jax_get_config(arch).smoke()
    for want, got in (
        (jax_layers.qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), use_rope=False),
         layers.qkv(cfg, tp, torch.as_tensor(x))),
        (jax_layers.qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(pos)),
         layers.qkv(cfg, tp, torch.as_tensor(x), torch.as_tensor(pos))),
    ):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_spec_trees_match_jax_leaf_by_leaf(arch):
    jm, tm = JaxModel(jax_get_config(arch).smoke()), Model(get_config(arch).smoke())
    assert_specs_equal(tm.param_specs(), jm.param_specs())
    for cache_len in (8, 64):
        shape = ShapeSpec("serve", "decode", cache_len, 2)
        assert_specs_equal(tm.cache_specs(shape), jm.cache_specs(shape))


@pytest.mark.parametrize("arch,n,gap", [
    (WHISPER, 793_444_352, 372_736),  # MLP biases 245,760; LayerNorm biases 122,880; ln_enc, ln_f
    (LLAVA, 34_388_917_248, 7_168),  # ln_f
])
def test_parameter_count_of_the_spec_tree(arch, n, gap):
    cfg = get_config(arch)
    assert sum(int(np.prod(s.shape)) for _, s in leaves(Model(cfg).param_specs())) == n
    assert n - cfg.num_params() == gap


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.encdec.enc_positions, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("S", [5, 16, 23])
def test_whisper_prefill_and_decode_match_jax(whisper, S):
    jm, jp, tm, tp = whisper
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    frames = _frames(jm.cfg, 2, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long),
                             "frames": torch.as_tensor(frames)}, 32)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    xk = tc["xk"]
    for _ in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, out = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        assert out is tc and out["xk"] is xk
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        assert_trees_close(tc, jc, **TOL)


def test_whisper_decode_from_a_converted_jax_cache(whisper):
    jm, jp, tm, tp = whisper
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, size=(1, 23)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(_frames(jm.cfg, 1, 5))}, 32)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    assert sorted(tc) == ["k", "len", "v", "xk", "xv"]
    tok = np.array([7], np.int32)
    jl, _ = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
    tl, _ = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)


SERVE = dict(batch_slots=2, cache_len=32, max_new_tokens=4)


@pytest.fixture(scope="module")
def served(whisper, tmp_path_factory):
    """One traced serving run of the whisper smoke model per package
    (default mode), same weights and prompts; each engine feeds zero frames."""
    jm, jp, tm, tp = whisper
    out = {}
    for name, (Tr, Cfg, Eng, SCfg, model, params) in {
        "jax": (JaxTracer, JaxTraceConfig, JaxServeEngine, JaxServeConfig, jm, jp),
        "torch": (Tracer, TraceConfig, ServeEngine, ServeConfig, tm, tp),
    }.items():
        d = str(tmp_path_factory.mktemp(f"encdec_{name}"))
        eng = Eng(model, params, SCfg(**SERVE))
        reqs = [eng.submit(p) for p in serve_prompts(model.cfg.vocab_size)]
        with Tr(Cfg(out_dir=d, mode="default")):
            eng.run_until_drained()
        out[name] = (d, [r.out_tokens for r in reqs])
    return out


def test_whisper_serving_matches_jax_greedy_tokens(served):
    (_, jtoks), (_, ttoks) = served["jax"], served["torch"]
    assert ttoks == jtoks
    assert all(len(t) == SERVE["max_new_tokens"] for t in ttoks)


def test_whisper_traced_serving_tallies_under_the_jax_package(served):
    """72 flash launches a prefill at full width: here 2 encoder layers and
    4 decoder layers of self and cross attention."""
    d, _ = served["torch"]
    jt, tt = jax_tally_trace(d), tally_trace(d)
    assert jt.to_obj()["apis"] == tt.to_obj()["apis"]
    assert jt.to_obj()["device_apis"] == tt.to_obj()["device_apis"]
    cfg = get_config(WHISPER).smoke()
    prefills = tt.apis[("ust_repro", "prefill")].calls
    per_prefill = cfg.encdec.enc_layers + 2 * cfg.num_layers
    assert prefills == 4 and tt.device_apis[("ust_kernel", "flash_attention")].calls == per_prefill * prefills


def test_one_slot_engine_serves_the_jax_models_greedy_tokens(whisper):
    """With zero frames, as the engine feeds them (the JAX engine's one-slot
    splice is ROADMAP fault 1)."""
    jm, jp, tm, tp = whisper
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=1, cache_len=32, max_new_tokens=4))
    prompts = serve_prompts(tm.cfg.vocab_size)[:3]
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    zeros = jnp.zeros((1, jm.cfg.encdec.enc_positions, jm.cfg.d_model), jnp.float32)

    class Framed:  # the JAX model with the engine's zero frames in every prefill
        cfg = jm.cfg

        def prefill(self, p, batch, cache_len):
            return jm.prefill(p, {**batch, "frames": zeros}, cache_len)

        def decode_step(self, p, cache, batch):
            return jm.decode_step(p, cache, batch)

    assert [r.out_tokens for r in reqs] == [_jax_greedy(Framed(), jp, p, 32, 4) for p in prompts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_feeds_zero_frames_in_the_cache_dtype(dtype, monkeypatch):
    model = Model(dataclasses.replace(get_config(WHISPER).smoke(), dtype=dtype))
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(batch_slots=2, cache_len=16, max_new_tokens=2))
    seen = []
    real = model.prefill
    monkeypatch.setattr(model, "prefill", lambda p, b, n: seen.append(b) or real(p, b, n))
    eng.submit(np.arange(5))
    eng.run_until_drained()
    (batch,) = seen
    frames = batch["frames"]
    assert eng.cache_dtype() == frames.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert tuple(frames.shape) == (1, model.cfg.encdec.enc_positions, model.cfg.d_model)
    assert not frames.any() and frames.device == eng.device


@pytest.mark.parametrize("S", [5, 16])
def test_vlm_prefill_with_patch_embeds_and_decode_match_jax(llava, S):
    jm, jp, tm, tp = llava
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    patches = rng.normal(0, 0.02, size=(2, jm.cfg.vision_tokens, jm.cfg.d_model)).astype(np.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long),
                             "patch_embeds": torch.as_tensor(patches)}, 32)
    assert tc["len"].tolist() == [jm.cfg.vision_tokens + S] * 2
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    for _ in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        assert_trees_close(tc, jc, **TOL)


def test_engine_refuses_a_vlm(llava):
    _, _, tm, tp = llava
    with pytest.raises(NotImplementedError, match="patch_embeds"):
        ServeEngine(tm, tp, ServeConfig(**SERVE))
