"""PyTorch port, the training forward, the optimizer and the data pipeline
against the JAX package.

The JAX smoke models' weights (``Model.init(PRNGKey(0))``) are carried
across with ``repro_torch.convert``, so both packages compute the same
function on the same numpy inputs, fp32 on the CPU.  Tolerances:
``xent_loss`` and the attentions 1e-5; ``forward_train`` logits and
``Model.loss`` 1e-5; every parameter's gradient against ``jax.grad``
max|Δ|/max|g| ≤ 1e-4; AdamW, the schedule and the int8 round trip 1e-6
or exact; the pipeline's batches byte for byte.  The families trained are
the dense (h2o-danube-1.8b), VLM (llava-next-34b), MoE (moonshot-v1-16b-a3b,
its load-balance term in the loss) and audio (whisper-medium, over random
frames) ones.
"""

import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.data import pipeline as jax_pipeline
from repro.models import Model as JaxModel
from repro.models import ShapeSpec as JaxShapeSpec
from repro.models import layers as jl
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import compression as jc
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data import DataConfig, SyntheticPipeline, make_eval_batch
from repro_torch.models import Model, ShapeSpec
from repro_torch.models import layers as tl
from repro_torch.models import moe, transformer
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, warmup_cosine
from repro_torch.optim import compression as tc

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4  # max|Δ| / max|g| per parameter
DANUBE, LLAVA = "h2o-danube-1.8b", "llava-next-34b"
MOONSHOT, WHISPER = "moonshot-v1-16b-a3b", "whisper-medium"
TRAINED = [DANUBE, LLAVA, MOONSHOT, WHISPER]


@functools.lru_cache(maxsize=None)
def pair(arch, **over):
    """(JAX model, JAX params, port model, port params) — same weights."""
    jm = JaxModel(dataclasses.replace(jax_get_config(arch).smoke(), **over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(get_config(arch).smoke(), **over))
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def train_batch(cfg, S, seed, B=2):
    """tokens, labels (and patch embeddings for a VLM, frames for audio) for
    S positions."""
    rng = np.random.default_rng(seed)
    n = S - cfg.vision_tokens
    toks = rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.vision_tokens:
        out["patch_embeds"] = (rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, cfg.encdec.enc_positions, cfg.d_model)).astype(np.float32)
    return out


def qkv_inputs(B, S, T, H, Kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, S, H, d), (B, T, Kv, d), (B, T, Kv, d))]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [256, 250])
def test_xent_loss_matches_jax(vocab):
    """250 leaves 6 padded columns (vocab_multiple 16), masked to -1e30."""
    cfg = dataclasses.replace(get_config(DANUBE).smoke(), vocab_size=vocab)
    jcfg = dataclasses.replace(jax_get_config(DANUBE).smoke(), vocab_size=vocab)
    assert cfg.padded_vocab == 256
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 256)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, size=(3, 7)).astype(np.int32)
    want = float(jl.xent_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tl.xent_loss(cfg, torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, **TOL)


ATTN_CASES = [  # B, S, T, H, Kv, d, causal, window
    (2, 16, 16, 4, 2, 16, True, None),
    (1, 23, 23, 4, 2, 16, True, 8),
    (2, 12, 20, 4, 1, 8, True, None),  # S < T: queries at the end of the timeline
    (1, 20, 12, 4, 4, 8, True, None),  # S > T
    (1, 9, 9, 2, 2, 8, False, 4),  # window without causal
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_attention_matches_jax(case, chunk):
    """``attend`` (chunk None) and ``attend_chunked``; chunk 5 does not divide
    most T here, so those calls are one block, as in JAX."""
    B, S, T, H, Kv, d, causal, window = case
    q, k, v = qkv_inputs(B, S, T, H, Kv, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    q_, k_, v_ = map(torch.from_numpy, (q, k, v))
    if chunk is None:
        want = jl.attend(jq, jk, jv, causal=causal, window=window)
        got = tl.attend(q_, k_, v_, causal=causal, window=window)
    else:
        want = jl.attend_chunked(jq, jk, jv, causal=causal, window=window, chunk=chunk)
        got = tl.attend_chunked(q_, k_, v_, causal=causal, window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl,chunk", [("dense", 2048), ("chunked", 8), ("chunked", 7), ("chunked", 64)])
def test_attend_cfg_matches_jax(impl, chunk):
    """chunk 8 blocks T=24; 7 does not divide it (one block); 64 is longer
    than T, so the materialized path runs."""
    cfg = dataclasses.replace(get_config(DANUBE).smoke(), attn_impl=impl, attn_chunk=chunk)
    jcfg = dataclasses.replace(jax_get_config(DANUBE).smoke(), attn_impl=impl, attn_chunk=chunk)
    q, k, v = qkv_inputs(2, 24, 24, 4, 2, 16, seed=1)
    want = jl.attend_cfg(jcfg, *map(jnp.asarray, (q, k, v)), causal=True, window=cfg.sliding_window)
    got = tl.attend_cfg(cfg, *map(torch.from_numpy, (q, k, v)), causal=True, window=cfg.sliding_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_attention_gradients_match_jax():
    q, k, v = qkv_inputs(1, 16, 16, 4, 2, 8, seed=2)

    def jloss(q, k, v):
        return jnp.sum(jl.attend_chunked(q, k, v, causal=True, window=6, chunk=4) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    torch.sum(tl.attend_chunked(*ts, causal=True, window=6, chunk=4) ** 2).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# forward_train, loss and gradients
# ---------------------------------------------------------------------------


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", TRAINED)
@pytest.mark.parametrize("S", [16, 23])
def test_forward_train_and_loss_match_jax(arch, S):
    """llava's S counts its 8 patch embeddings; its loss covers the text.
    moonshot's loss adds ``aux_loss_weight`` times its load-balance term;
    the other families' aux is an fp32 zero."""
    jm, jp, tm, tp = pair(arch)
    b = train_batch(tm.cfg, S, seed=S)
    want_logits, want_aux = jm.logits(jp, jax_batch(b))
    got_logits, aux = tm.logits(tp, torch_batch(b))
    assert tuple(got_logits.shape) == (2, S, tm.cfg.padded_vocab)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    (want, wm), (got, gm) = jm.loss(jp, jax_batch(b)), tm.loss(tp, torch_batch(b))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **TOL)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), **TOL)
    if tm.cfg.family == "moe":
        assert float(gm["aux"]) > 0.5
        np.testing.assert_allclose(float(got), float(gm["ce"]) + tm.cfg.moe.aux_loss_weight * float(gm["aux"]),
                                   rtol=1e-6)
    else:
        assert float(gm["aux"]) == float(wm["aux"]) == 0.0 and float(got) == float(gm["ce"])


@pytest.mark.parametrize("arch", TRAINED)
@pytest.mark.parametrize("S", [16, 23])
def test_every_gradient_matches_jax_grad(arch, S):
    jm, jp, tm, tp = pair(arch)
    b = train_batch(tm.cfg, S, seed=100 + S)
    want = jax.grad(lambda p: jm.loss(p, jax_batch(b))[0])(jp)
    p = tree.map(lambda t: t.detach().requires_grad_(True), tp)
    got = torch.autograd.grad(tm.loss(p, torch_batch(b))[0], tree.leaves(p))
    want_items = list(tree.items(jax.tree_util.tree_map(np.asarray, want)))
    assert [k for k, _ in want_items] == [k for k, _ in tree.items(tp)]
    for (key, w), g in zip(want_items, got, strict=True):
        rel = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert rel <= GRAD_TOL, (key, rel)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_remat_full_gives_the_same_gradients(remat):
    """``remat="full"`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``); the gradients are JAX's either way."""
    jm, jp, _, tp = pair(DANUBE)
    tm = Model(dataclasses.replace(get_config(DANUBE).smoke(), remat=remat))
    b = train_batch(tm.cfg, 16, seed=7)
    want = jax.tree_util.tree_leaves(jax.grad(lambda p: jm.loss(p, jax_batch(b))[0])(jp))
    p = tree.map(lambda t: t.detach().requires_grad_(True), tp)
    got = torch.autograd.grad(tm.loss(p, torch_batch(b))[0], tree.leaves(p))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() <= GRAD_TOL


@pytest.mark.parametrize("arch", [MOONSHOT, WHISPER])
def test_remat_full_gradients_match_jax_for_moe_and_audio(arch):
    """``remat="full"`` on both sides: moonshot's block returns its aux
    beside x through the checkpoint, whisper's encoder and decoder blocks
    are each recomputed (the decoder's takes the encoder states as an
    input)."""
    jm, jp, tm, tp = pair(arch, remat="full")
    assert tm.cfg.remat == "full"
    b = train_batch(tm.cfg, 16, seed=11)
    want = jax.grad(lambda p: jm.loss(p, jax_batch(b))[0])(jp)
    p = tree.map(lambda t: t.detach().requires_grad_(True), tp)
    got = torch.autograd.grad(tm.loss(p, torch_batch(b))[0], tree.leaves(p))
    for (key, w), g in zip(tree.items(jax.tree_util.tree_map(np.asarray, want)), got, strict=True):
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), key


def _grads(tm, tp, b):
    p = tree.map(lambda t: t.detach().requires_grad_(True), tp)
    return torch.autograd.grad(tm.loss(p, torch_batch(b))[0], tree.leaves(p))


@pytest.mark.parametrize("arch", TRAINED)
def test_remat_dots_gives_the_gradients_of_none(arch):
    """``remat="dots"`` recomputes in the backward pass what it did not
    keep; in fp32 the gradients are ``"none"``'s within 1e-6."""
    _, _, tm, tp = pair(arch)
    dots = Model(dataclasses.replace(tm.cfg, remat="dots"))
    b = train_batch(tm.cfg, 16, seed=21)
    for g, w in zip(_grads(dots, tp, b), _grads(tm, tp, b), strict=True):
        assert float((g - w).abs().max()) <= 1e-6 * max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", [DANUBE, MOONSHOT, WHISPER])
def test_remat_dots_gradients_match_jax(arch):
    """``remat="dots"`` on both sides (JAX: ``checkpoint_dots_with_no_batch_dims``)."""
    jm, jp, tm, tp = pair(arch, remat="dots")
    assert tm.cfg.remat == jm.cfg.remat == "dots"
    b = train_batch(tm.cfg, 16, seed=12)
    want = jax.grad(lambda p: jm.loss(p, jax_batch(b))[0])(jp)
    for (key, w), g in zip(tree.items(jax.tree_util.tree_map(np.asarray, want)), _grads(tm, tp, b), strict=True):
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), key


def _no_batch_dot_sizes(jaxpr) -> list:
    """Element counts of the outputs of the ``dot_general``s with no batch
    dimensions in ``jaxpr`` and the jaxprs nested in it."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and not eqn.params["dimension_numbers"][1][0]:
            out.append(int(np.prod(eqn.outvars[0].aval.shape)))
        for v in eqn.params.values():
            inner = getattr(v, "jaxpr", v)
            if hasattr(inner, "eqns"):
                out += _no_batch_dot_sizes(inner)
    return out


def _kept_sizes(fn, *inputs) -> list:
    """Element counts (fp32) of the storages made inside ``fn``'s forward
    that are still alive when it returns, other than its outputs': what
    autograd keeps for the backward pass."""
    made = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.extend(weakref.ref(t.untyped_storage()) for t in pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            return out

    fn(*inputs)  # the RoPE table is made once, and cached
    with Spy():
        out = fn(*inputs)
    gc.collect()
    skip = {id(t.untyped_storage()) for t in pytree.tree_leaves((inputs, out)) if isinstance(t, torch.Tensor)}
    alive = {id(st): st for st in (r() for r in made) if st is not None and id(st) not in skip}
    return sorted(st.nbytes() // 4 for st in alive.values())


@pytest.mark.parametrize("arch", [DANUBE, MOONSHOT])
def test_remat_dots_keeps_exactly_the_no_batch_products(arch):
    """Inside one block, ``"dots"`` keeps for the backward pass the outputs
    of the products that have no batch dimensions, as the JAX policy
    counts them from the ``dot_general``s' dimension numbers: the Q, K, V
    and output projections and the MLP's three products (danube); the
    projections, the router and the experts' gate and up products, whose
    expert axis is the weight's (moonshot).  ``"full"`` keeps nothing,
    ``"none"`` keeps more.  (JAX's own residuals drop those the backward
    pass does not read, such as the MLP's down product.)"""
    jm, jp, tm, tp = pair(arch)
    B, S = 2, 8
    x = np.random.default_rng(3).standard_normal((B, S, tm.cfg.d_model)).astype(np.float32)
    jpl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    jpos = jnp.arange(S)[None]
    if tm.cfg.family == "moe":
        jfn = lambda pl, h: jax_moe.block(jm.cfg, pl, h, jpos, None)[0]  # noqa: E731
    else:
        jfn = lambda pl, h: jax_transformer.block(jm.cfg, pl, h, jpos)  # noqa: E731
    want = sorted(_no_batch_dot_sizes(jax.make_jaxpr(jfn)(jpl, jnp.asarray(x)).jaxpr))
    block = moe.block if tm.cfg.family == "moe" else transformer.block
    pl = tree.map(lambda t: t[0].detach().requires_grad_(True), tp["blocks"])
    h = torch.from_numpy(x).requires_grad_(True)
    pos = torch.arange(S)[None]
    kept = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tm.cfg, remat=remat)
        kept[remat] = _kept_sizes(transformer._remat(cfg, lambda p, y, q, cfg=cfg: block(cfg, p, y, q)[0]), pl, h, pos)
    assert kept["dots"] == want and len(want) == 7
    assert kept["full"] == []
    assert len(kept["none"]) > len(kept["dots"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_logits_refuses_the_families_not_ported(arch):
    tm = Model(get_config(arch).smoke())
    with pytest.raises(NotImplementedError, match="ROADMAP section 4"):
        tm.logits({}, {})


@pytest.mark.parametrize("arch", [DANUBE, LLAVA, "whisper-medium", MOONSHOT])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_match_jax(arch, kind):
    jm, tm = JaxModel(jax_get_config(arch).smoke()), Model(get_config(arch).smoke())
    want = jm.batch_specs(JaxShapeSpec("s", kind, 32, 2))
    got = tm.batch_specs(ShapeSpec("s", kind, 32, 2))
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].shape, got[k].axes, got[k].dtype) == (want[k].shape, want[k].axes, want[k].dtype), k


@pytest.mark.parametrize("arch", [DANUBE, LLAVA, "moonshot-v1-16b-a3b", "mamba2-1.3b"])
def test_model_flops_and_shapes_match_jax(arch):
    jm, tm = JaxModel(jax_get_config(arch)), Model(get_config(arch))
    assert tm.model_flops_per_token() == jm.model_flops_per_token()
    want = list(tree.items(jax.tree_util.tree_map(lambda s: f"{tuple(s.shape)} {s.dtype}", jm.shapes())))
    got = [(k, f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}") for k, t in tree.items(tm.shapes())]
    assert got == want
    assert all(t.device.type == "meta" for t in tree.leaves(tm.shapes()))


# ---------------------------------------------------------------------------
# Optimizer, schedule, compression
# ---------------------------------------------------------------------------


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("clip_norm", [1e3, 0.5])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_update_matches_jax(clip_norm, weight_decay):
    """Three updates, each written into the tensors it was given; clip_norm
    0.5 clips every one (the grads' norm is ~6)."""
    p = _params(0)
    jcfg = JaxAdamWConfig(clip_norm=clip_norm, weight_decay=weight_decay)
    cfg = AdamWConfig(clip_norm=clip_norm, weight_decay=weight_decay)
    jp, jst = jax.tree_util.tree_map(jnp.asarray, p), jax_adamw_init(p, jcfg)
    tp = tree.map(lambda a: torch.from_numpy(a.copy()), p)
    tst = adamw_init(tp, cfg)
    for i in range(3):
        g = _params(10 + i)
        lr = 1e-2 * (i + 1)
        jp, jst, jn = jax_adamw_update(jax.tree_util.tree_map(jnp.asarray, g), jst, jp, lr, jcfg)
        out_p, out_st, tn = adamw_update(tree.map(torch.from_numpy, g), tst, tp, lr, cfg)
        assert out_st is tst and all(a is b for a, b in zip(tree.leaves(out_p), tree.leaves(tp)))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for got, want in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp), strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        for m in ("mu", "nu"):
            for got, want in zip(tree.leaves(tst[m]), jax.tree_util.tree_leaves(jst[m]), strict=True):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
        assert int(tst["count"]) == int(jst["count"]) == i + 1
    assert tst["count"].dtype == torch.int32


def test_global_norm_matches_jax():
    g = _params(3)
    want = jax.tree_util.tree_map(jnp.asarray, g)
    from repro.optim import global_norm as jax_global_norm

    np.testing.assert_allclose(float(global_norm(tree.map(torch.from_numpy, g))), float(jax_global_norm(want)), rtol=1e-6)


def test_bf16_state_dtype_keeps_the_moments_in_bf16():
    p = tree.map(torch.from_numpy, _params(0))
    st = adamw_init(p, AdamWConfig(state_dtype="bfloat16"))
    _, st, _ = adamw_update(tree.map(torch.from_numpy, _params(1)), st, p, 1e-3, AdamWConfig(state_dtype="bfloat16"))
    assert {t.dtype for t in tree.leaves(st["mu"]) + tree.leaves(st["nu"])} == {torch.bfloat16}


def test_warmup_cosine_matches_jax_over_the_whole_schedule():
    kw = dict(peak_lr=3e-4, warmup=7, total=40)
    steps = np.arange(0, 46)
    want = np.asarray([float(jax_warmup_cosine(s, **kw)) for s in steps])
    got = np.asarray([float(warmup_cosine(int(s), **kw)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(warmup_cosine(torch.tensor(12, dtype=torch.int32), **kw).item(), want[12], rtol=1e-6)


@pytest.mark.parametrize("shape", [(6,), (3, 8), (2, 3, 5), (4, 1)])
def test_int8_quantize_dequantize_matches_jax(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(np.float32)
    if len(shape) > 1:
        x[0] = 0.0  # an all-zero row: scale 1
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.dequantize_int8(tq, ts).numpy(), np.asarray(jc.dequantize_int8(jq, js)))


def test_topk_sparsify_and_densify_match_jax():
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    jv, ji = jc.topk_sparsify(jnp.asarray(x), 6)
    tv, ti = tc.topk_sparsify(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.topk_densify(tv, ti, 35).numpy(), np.asarray(jc.topk_densify(jv, ji, 35)))


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TRAINED)
@pytest.mark.parametrize("seed", [0, 1234, 99])
@pytest.mark.parametrize("dp_rank", [0, 1])
def test_pipeline_batches_equal_jax_byte_for_byte(arch, seed, dp_rank):
    shape = ShapeSpec("p", "train", 24, 4)
    jpipe = JaxPipeline(JaxModel(jax_get_config(arch).smoke()), JaxShapeSpec("p", "train", 24, 4),
                        JaxDataConfig(seed=seed), dp_rank=dp_rank, dp_size=2)
    tpipe = SyntheticPipeline(Model(get_config(arch).smoke()), shape, DataConfig(seed=seed), dp_rank=dp_rank, dp_size=2)
    for step in range(3):
        want, got = next(jpipe), next(tpipe)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), (step, k)
    assert tpipe.state_dict() == jpipe.state_dict()


def test_pipeline_prefetch_and_restore_match_jax():
    """The prefetch thread's batches, and a pipeline restored from the
    state of another, are those of the JAX pipeline at the same steps."""
    model, jmodel = Model(get_config(DANUBE).smoke()), JaxModel(jax_get_config(DANUBE).smoke())
    shape, jshape = ShapeSpec("p", "train", 16, 2), JaxShapeSpec("p", "train", 16, 2)
    a = SyntheticPipeline(model, shape).start()
    try:
        first = [next(a) for _ in range(3)]
        state = a.state_dict()
    finally:
        a.stop()
    b = SyntheticPipeline(model, shape)
    b.load_state_dict(state)
    j = JaxPipeline(jmodel, jshape)
    for step, got in enumerate(first + [next(b), next(b)]):
        want = j.batch_at(step)
        assert all(got[k].tobytes() == want[k].tobytes() for k in want), step
    with pytest.raises(ValueError, match="seed"):
        b.load_state_dict({"step": 0, "seed": 5})


def test_eval_batch_matches_jax():
    want = jax_pipeline.make_eval_batch(JaxModel(jax_get_config(DANUBE).smoke()), JaxShapeSpec("e", "train", 16, 2))
    got = make_eval_batch(Model(get_config(DANUBE).smoke()), ShapeSpec("e", "train", 16, 2))
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)


def test_state_from_jax_carries_the_optimizer_state():
    jm, jp, tm, _ = pair(DANUBE)
    jst = {"params": jp, "opt": jax_adamw_init(jp, JaxAdamWConfig())}
    st = state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    assert st["opt"]["count"].dtype == torch.int32 and st["opt"]["count"].ndim == 0
    assert [k for k, _ in tree.items(st)] == [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jst)[0]
    ]
