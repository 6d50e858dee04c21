"""PyTorch port, Mamba2 model and serving engine against the JAX package.

The JAX smoke model's weights (``Model.init(PRNGKey(0))``) are carried across
with ``repro_torch.convert``, so both packages compute the same function; on
the CPU both run their plain SSD versions.  fp32 throughout, tolerance 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) — same weights."""
    jm = JaxModel(jax_get_config("mamba2-1.3b").smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("mamba2-1.3b").smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def np32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_config_and_spec_tree_match_jax(pair):
    jm, jp, tm, tp = pair
    assert tm.cfg == get_config("mamba2-1.3b").smoke()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
    assert len(flat) == sum(1 for _ in _leaves(tp))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_init_draws_the_declared_shapes_from_the_generator():
    m = Model(get_config("mamba2-1.3b").smoke())
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    A = -torch.exp(a["blocks"]["A_log"])
    assert bool(((A <= -1.0) & (A >= -16.0)).all())
    dt = torch.nn.functional.softplus(a["blocks"]["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_matches_jax(arch):
    cfg, want = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(want.smoke())
    assert cfg.active_params() == want.active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_serves_a_prefill_and_a_decode_step(arch):
    """Every config's smoke model builds, prefills (with the stub frames or
    patch embeddings its family reads) and decodes one step."""
    model = Model(get_config(arch).smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.arange(6)[None] % cfg.vocab_size}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(1, cfg.encdec.enc_positions, cfg.d_model)
    if cfg.vision_tokens:
        batch["patch_embeds"] = torch.zeros(1, cfg.vision_tokens, cfg.d_model)
    logits, cache = model.prefill(params, batch, 16)
    assert tuple(logits.shape) == (1, 1, cfg.padded_vocab)
    logits, cache = model.decode_step(params, cache, {"token": torch.zeros(1, dtype=torch.int32)})
    assert tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    assert int(cache["len"][0]) == 6 + cfg.vision_tokens + 1


@pytest.mark.parametrize("S", [8, 16])
def test_prefill_and_decode_match_jax(pair, S):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, 64)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(np32(tc[k]), np32(jc[k]), **TOL)
    assert tc["len"].dtype == torch.int32
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for _ in range(4):
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2,)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        for k in ("conv", "state"):
            np.testing.assert_allclose(np32(tc[k]), np32(jc[k]), **TOL)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_decode_from_a_converted_jax_cache(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, size=(1, 8)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    tok = np.array([7], np.int32)
    jl, _ = jm.decode_step(jp, jc, {"token": jnp.asarray(tok)})
    tl, _ = tm.decode_step(tp, tc, {"token": torch.as_tensor(tok, dtype=torch.long)})
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)


def test_bf16_params_keep_their_bits():
    a = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jb = np.asarray(jnp.asarray(a, jnp.bfloat16))
    t = params_from_jax({"w": jb}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), jb.astype(np.float32))


def serve_prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, size=(S,)) for S in (8, 16, 8)]


def test_serving_matches_jax_greedy_tokens(pair):
    jm, jp, tm, tp = pair
    cfg = dict(batch_slots=2, cache_len=32, max_new_tokens=5)
    je = JaxServeEngine(jm, jp, JaxServeConfig(**cfg))
    te = ServeEngine(tm, tp, ServeConfig(**cfg))
    prompts = serve_prompts(jm.cfg.vocab_size)
    jr = [je.submit(p) for p in prompts]
    tr = [te.submit(p) for p in prompts]
    je.run_until_drained()
    te.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(len(r.out_tokens) == 5 for r in tr)


def test_single_slot_splice_replaces_the_whole_row(pair):
    """With one slot the prefill row has the cache's own shape: the splice
    copies it whole (the batch axis cannot be found by shape)."""
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, ServeConfig(batch_slots=1, cache_len=32, max_new_tokens=3))
    prompt = serve_prompts(tm.cfg.vocab_size)[0]
    r = eng.submit(prompt)
    eng.run_until_drained()
    logits, cache = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])}, 32)
    toks = [int(torch.argmax(logits[0, 0, : tm.cfg.vocab_size]))]
    for _ in range(2):
        logits, cache = tm.decode_step(tp, cache, {"token": torch.tensor([toks[-1]])})
        toks.append(int(torch.argmax(logits[0, 0, : tm.cfg.vocab_size])))
    assert r.out_tokens == toks
