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
from repro_torch.kernels import ops
from repro_torch.models import Model
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


def test_two_layer_full_width_train_step_matches_the_cpu(cuda):
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(4))
    cpu_params = tree.map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out, grads = {}, {}
    sides = {"cuda": (cuda, params), "cpu": (torch.device("cpu"), cpu_params)}
    for name, (dev, p) in sides.items():
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
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
