"""On a CUDA card: the engine's decode step replays a captured CUDA graph and
gives what the model's eager ``decode_step`` gives.

For each family the engine serves (at smoke width; Mamba2 at its published
width with two layers, the widths the SSD kernel is built for): before every decode step
the cache and the token buffer are cloned, the engine steps (its first step
runs eagerly and captures the graph, the later ones replay it), and the
eager step runs on the clone.  Greedy tokens are identical; every cache leaf and the logits
agree within 1e-5 relative in fp32 (cuBLAS may pick another algorithm under
capture).  A call with other storages raises.  The graph of the hybrid holds
one RG-LRU launch for each recurrent block.  The VLM, which the engine does
not serve, steps through ``decode_artifacts`` after ``Model.prefill`` with
patch embeddings, against the eager step the same way.

The graph exists only on the card, so every case carries the ``cuda``
marker and skips without one.  This file imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.artifacts import DecodeGraph, decode_artifacts

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "h2o-danube-1.8b", "moonshot-v1-16b-a3b", "whisper-medium")
PROMPT_LENS = (8, 16, 8, 24, 8)
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step's graph exists only there")
    return torch.device("cuda")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _engine(arch, device):
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=2) if cfg.family == "ssm" else cfg.smoke()
    model = Model(dataclasses.replace(cfg, dtype="float32"))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(batch_slots=2, cache_len=32, max_new_tokens=5))
    rng = np.random.default_rng(5)
    for S in PROMPT_LENS:
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=(S,)))
    return model, params, eng


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_replayed_decode_matches_the_eager_step(cuda, arch):
    model, params, eng = _engine(arch, cuda)
    assert isinstance(eng.decode_fn, DecodeGraph)
    V = model.cfg.vocab_size
    steps = 0
    while True:
        eng._fill_slots()  # refill first, so the clone sees what the step sees
        if not any(s is not None for s in eng.slots):
            break
        cache, tok = _clone(eng.cache), eng._tok.clone()
        eng.step()
        steps += 1
        logits, cache = model.decode_step(params, cache, {"token": tok})
        want = torch.argmax(logits[:, 0, :V], dim=-1).to(torch.int32)
        assert torch.equal(eng._tok, want), f"step {steps}"
        if steps > 1:  # a replay: its static logits
            assert _rel(eng.decode_fn._out[0], logits) <= TOL
        for got, ref in zip(_leaves(eng.cache), _leaves(cache), strict=True):
            assert got.dtype == ref.dtype and _rel(got, ref) <= TOL, f"step {steps}"
    assert eng.decode_fn.replays == steps - 1 >= 4
    assert len(eng.completed) == len(PROMPT_LENS)
    n_rec = model.cfg.block_counts()[1] if model.cfg.family == "hybrid" else 0
    assert eng.decode_fn.captured == ({"rglru_scan": n_rec} if n_rec else {})


@pytest.mark.cuda
def test_vlm_replayed_decode_matches_the_eager_step(cuda):
    model = Model(get_config("llava-next-34b").smoke())
    cfg = model.cfg
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (2, 12), device=cuda, generator=g),
        "patch_embeds": 0.02 * torch.randn(2, cfg.vision_tokens, cfg.d_model, device=cuda, generator=g),
    }
    logits, cache = model.prefill(params, batch, 40)
    step = decode_artifacts(model, cuda)
    assert isinstance(step, DecodeGraph)
    tok = torch.argmax(logits[:, 0, : cfg.vocab_size], dim=-1).to(torch.int32)
    for n in range(6):
        clone, want_tok = _clone(cache), tok.clone()
        got, _ = step(params, cache, {"token": tok})
        logits, clone = model.decode_step(params, clone, {"token": want_tok})
        assert _rel(got, logits) <= TOL, f"step {n}"
        for a, b in zip(_leaves(cache), _leaves(clone), strict=True):
            assert _rel(a, b) <= TOL, f"step {n}"
        tok.copy_(torch.argmax(got[:, 0, : cfg.vocab_size], dim=-1))
    assert step.replays == 5 and step.captured == {}
    assert cache["len"].tolist() == [cfg.vision_tokens + 12 + 6] * 2


@pytest.mark.cuda
def test_a_call_with_other_storages_raises(cuda):
    model, params, eng = _engine("recurrentgemma-2b", cuda)
    eng.step()
    eng.step()
    with pytest.raises(RuntimeError, match="other tensors"):
        eng.decode_fn(params, _clone(eng.cache), {"token": eng._tok})
