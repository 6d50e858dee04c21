"""On a CUDA card: a traced serving session with live tracing on.

A two-layer h2o-danube-1.8b at its published width (bf16, random weights
from a seed) serves under a full-mode session with device sampling and an
in-process master (``serve_port=0``); the engine ticks one adaptive policy
between the decode graph's replays.  At stop the master's live composite
equals the offline tally of the session's trace exactly, per API in (calls,
total_ns); the streamed telemetry carries the card's memory figures; the
engine captured its decode step once (``replays`` = steps - 1) and ticked
once per step; and the greedy tokens equal those of an untraced session.  A
policy that turns tracing knobs mid-run (the fidelity rung, the snapshot
cadence) captures nothing again.

The decode graph and the flash kernel exist only on the card, so every case
carries the ``cuda`` marker and skips without one.  This file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_live_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import AdaptiveController, TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.artifacts import DecodeGraph

PROMPT_LENS = (100, 512, 300, 64, 200)
SERVE = dict(batch_slots=4, cache_len=512, max_new_tokens=8)


class CountingPolicy:
    """Counts its ticks; from ``turn_at`` on, turns tracing knobs."""

    name = "counting"

    def __init__(self, turn_at: int = 0):
        self.ticks = 0
        self.turn_at = turn_at

    def tick(self, ctx) -> None:
        self.ticks += 1
        if self.ticks == self.turn_at:
            ctx.set_mode("sampled", "mid-run knob turn")
            ctx.set_stream_period(0.05, "mid-run knob turn")


@pytest.fixture(scope="module")
def danube():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph and the flash kernel exist only there")
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(S,)) for S in PROMPT_LENS]
    return model, params, prompts


def _serve(model, params, prompts, cfg=None, policy=None):
    """(engine, tokens, tracer, policy's controller) of one session."""
    ctrl = None if policy is None else AdaptiveController([policy], period_s=0.0)
    eng = ServeEngine(model, params, ServeConfig(**SERVE), adaptive=ctrl)
    assert isinstance(eng.decode_fn, DecodeGraph)
    reqs = [eng.submit(p) for p in prompts]
    tr = None
    if cfg is None:
        eng.run_until_drained()
    else:
        with Tracer(cfg) as tr:
            eng.run_until_drained()
    return eng, [r.out_tokens for r in reqs], tr, ctrl


def _totals(t) -> dict:
    return {
        **{k: (s.calls, s.total_ns) for k, s in t.apis.items()},
        **{("device",) + k: (s.calls, s.total_ns) for k, s in t.device_apis.items()},
    }


@pytest.mark.cuda
def test_live_session_equals_its_offline_tally_and_the_untraced_tokens(danube, tmp_path):
    model, params, prompts = danube
    _, plain_tokens, _, _ = _serve(model, params, prompts)
    out = str(tmp_path / "t")
    cfg = TraceConfig(out_dir=out, mode="full", sample=True, serve_port=0, stream_period_s=0.05)
    policy = CountingPolicy()
    eng, tokens, tr, ctrl = _serve(model, params, prompts, cfg, policy)
    steps = tr.final_tally.apis[("ust_repro", "decode_step")].calls
    assert tokens == plain_tokens
    assert eng.decode_fn.replays == steps - 1 and ctrl.ticks == policy.ticks == steps - 1
    offline = tally_trace(out)
    assert _totals(tr.server.composite()) == _totals(offline)
    L = model.cfg.num_layers
    assert offline.device_apis[("ust_kernel", "flash_attention")].calls == L * len(prompts)
    (telem,) = tr.server.telemetry().values()
    assert telem["mem_in_use"] > 0 and telem["mem_limit"] >= telem["mem_peak"] >= telem["mem_in_use"]


@pytest.mark.cuda
def test_knob_turns_mid_run_capture_nothing_again(danube, tmp_path):
    model, params, prompts = danube
    _, plain_tokens, _, _ = _serve(model, params, prompts)
    cfg = TraceConfig(out_dir=str(tmp_path / "t"), mode="full", serve_port=0)
    policy = CountingPolicy(turn_at=2)
    eng, tokens, tr, ctrl = _serve(model, params, prompts, cfg, policy)
    assert [a.knob for a in ctrl.actions] == ["fidelity", "stream_period_s"]
    assert tr.handle.fidelity == "sampled"
    assert tokens == plain_tokens
    assert eng.decode_fn.replays == policy.ticks  # one capture: every later step replayed
