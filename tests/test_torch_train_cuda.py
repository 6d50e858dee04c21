"""On a CUDA card: training and the kernels' refusal of autograd.

No kernel has a backward pass (nor has any Pallas kernel of the JAX
package), so ``ops.flash_attention``, ``ops.ssd`` and ``ops.rglru`` raise
on CUDA inputs that require a gradient, and train steps run the plain
attention.  A two-layer full-width fp32 h2o-danube-1.8b train step on the
card is held against the same step on the CPU: loss, gradient norm, every
gradient, and the AdamW-updated weights from the CPU's gradients on both
devices (each device's own gradients reach the update divided by
sqrt(v) + eps, which magnifies the differences of gradients near eps),
each max|card − cpu| / max|cpu| within 1e-4 (the same fp32 arithmetic in
another order; TF32 is off).

The MoE (moonshot-v1-16b-a3b) and audio (whisper-medium) families train
the same way: their smoke loss's backward runs on the card with no flash
launch, a prefill on the same weights afterwards launches flash in every
attention (moonshot ``num_layers`` times, whisper ``enc_layers + 2 ×
num_layers``), and a two-layer full-width fp32 step (moonshot 1.81 B
parameters; whisper two encoder and two decoder layers over 1500 random
frames) is held against the CPU as danube's is, moonshot's top-k expert
sets first compared token by token.

Every case carries the ``cuda`` marker and skips without a card.  This file
imports neither JAX nor the JAX package, so it also runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import Model, ShapeSpec, moe
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.train.train_step import loss_and_grads

pytestmark = pytest.mark.cuda
REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, cuda, grad):
    return torch.randn(shape, device=cuda).requires_grad_(grad)


@pytest.mark.parametrize("grad", [True, False])
def test_ops_raise_under_grad_on_the_card(cuda, grad):
    q, k, v = _rand((1, 64, 4, 64), cuda, grad), _rand((1, 64, 2, 64), cuda, False), _rand((1, 64, 2, 64), cuda, False)
    x, r, i = (_rand((1, 16, 64), cuda, grad) for _ in range(3))
    lam = _rand((64,), cuda, False)
    xs, dt = _rand((1, 64, 2, 64), cuda, grad), torch.rand((1, 64, 2), device=cuda) * 0.1  # the SSD kernel's P=64
    A_log, D = _rand((2,), cuda, False), _rand((2,), cuda, False)
    Bm, Cm = _rand((1, 64, 1, 128), cuda, False), _rand((1, 64, 1, 128), cuda, False)  # N=128
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, k, v, causal=True),
        "rglru": lambda: ops.rglru(x, r, i, lam),
        "ssd": lambda: ops.ssd(xs, dt, A_log, Bm, Cm, D, chunk=64),
    }
    for name, call in calls.items():
        if grad:
            with pytest.raises(RuntimeError, match="no backward"):
                call()
            with torch.no_grad():
                call()  # without autograd the kernel runs
        else:
            call()


MOONSHOT, WHISPER = "moonshot-v1-16b-a3b", "whisper-medium"


def _flash_per_prefill(cfg) -> int:
    return cfg.num_layers + (cfg.encdec.enc_layers + cfg.num_layers if cfg.family == "audio" else 0)


@pytest.mark.parametrize("arch", [MOONSHOT, WHISPER])
def test_smoke_backward_launches_no_kernel_and_a_prefill_after_it_does(cuda, arch):
    model = Model(get_config(arch).smoke())
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    host = SyntheticPipeline(model, ShapeSpec("c", "train", 16, 2)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    flash_attention.launches = 0
    loss, grads, metrics = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches == 0
    assert torch.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))
    assert (float(metrics["aux"]) > 0) == (model.cfg.family == "moe")
    with torch.no_grad():
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = model.prefill(params, prompt, 32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert flash_attention.launches == _flash_per_prefill(model.cfg)


def _two_layer(arch):
    base = get_config(arch)
    over = dict(num_layers=2, dtype="float32")
    if base.family == "audio":
        over["encdec"] = dataclasses.replace(base.encdec, enc_layers=2)
    return dataclasses.replace(base, **over)


def _routes(cfg, params, batch):
    """Each layer's top-k expert ids, sorted per token, of a forward pass
    whose expert layer records its input."""
    seen = []
    ffn = moe.moe_ffn

    def recording(c, p, h):
        seen.append(moe._router(c, p["router"], h.reshape(-1, c.d_model))[1].sort(dim=-1).values.cpu())
        return ffn(c, p, h)

    moe.moe_ffn = recording
    try:
        with torch.no_grad():
            Model(cfg).logits(params, batch)
    finally:
        moe.moe_ffn = ffn
    return seen


@pytest.mark.parametrize("arch", [MOONSHOT, WHISPER])
def test_two_layer_full_width_moe_and_audio_train_steps_match_the_cpu(cuda, arch):
    """moonshot: 1 x 128 tokens; whisper: 1500 random frames and 1 x 128
    tokens.  For moonshot each layer's expert sets must agree on every
    token first (a near tie flipped by the order of the fp32 sums would
    move the gradients of two experts)."""
    cfg = _two_layer(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(5))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 129)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((1, cfg.encdec.enc_positions, cfg.d_model)).astype(np.float32)
    _card_against_cpu(cuda, model, params, batch)


def test_two_layer_full_width_train_step_matches_the_cpu(cuda):
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(4))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 257)).astype(np.int32)
    _card_against_cpu(cuda, model, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})


def _card_against_cpu(cuda, model, params, batch):
    """Loss, gradient norm, every gradient and the AdamW update from the
    CPU's gradients, card against CPU, each within REL of max|cpu|."""
    cpu_params = tree.map(lambda t: t.cpu(), params)
    out, grads = {}, {}
    sides = {"cuda": (cuda, params), "cpu": (torch.device("cpu"), cpu_params)}
    for name, (dev, p) in sides.items():
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
        if model.cfg.family == "moe" and name == "cuda":
            cpu_b = {k: t.cpu() for k, t in b.items()}
            for l, (a, c) in enumerate(zip(_routes(model.cfg, p, b), _routes(model.cfg, cpu_params, cpu_b))):
                assert torch.equal(a, c), f"layer {l}: tokens {(a != c).any(-1).nonzero().flatten().tolist()}"
        loss, grads[name], _ = loss_and_grads(model, p, b)
        out[name] = [loss, global_norm(grads[name])] + tree.leaves(grads[name])
    for name, (dev, p) in sides.items():
        g = tree.map(lambda t: t.to(dev), grads["cpu"])
        p = tree.map(torch.clone, p)
        new, _, _ = adamw_update(g, adamw_init(p, AdamWConfig()), p, 1e-3, AdamWConfig())
        out[name] += tree.leaves(new)
    for a, b in zip(out["cuda"], out["cpu"], strict=True):
        a = a.cpu().double()
        assert torch.isfinite(a).all()
        rel = (a - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)
        assert rel <= REL, rel
