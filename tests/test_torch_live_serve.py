"""Live tracing on the serving side, the port's engine against the JAX one.

For each smoke model family (dense, SSM, hybrid) the same weights serve the
same prompts through the JAX engine under ``repro.core.Tracer(serve_port=0)``
and through the port's under ``repro_torch.core.Tracer(serve_port=0)``, each
engine with one adaptive policy that counts its ticks, in default mode (a
full-mode JAX step on the CPU spins a varying number of ``poll_ready``
pairs; a CPU torch step needs no fence).  Mid-run and at the
end of the requests, ``live_tally()`` holds the same framework and runtime
APIs with the same calls in both packages (kernel rows by name: JAX records
one per trace, eager torch one per call, and the port's dense prefill adds
the flash kernel's row); at stop the port's live composite
equals its own offline tally exactly in (calls, total_ns); the engine ticks
its controller once per decode step; and a policy that moves the session to
another fidelity rung mid-run leaves the tokens as they were.  Every wait
has its own deadline.
"""

import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.adaptive import AdaptiveController as JaxAdaptiveController
from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import AdaptiveController, TraceConfig, Tracer
from repro_torch.core.plugins.tally import tally_trace
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine

PROMPT_LENS = (8, 16, 8)
SERVE = dict(batch_slots=2, cache_len=32, max_new_tokens=4)
MID_RUN_STEPS = 3
ARCHS = ("h2o-danube-1.8b", "mamba2-1.3b", "recurrentgemma-2b")
RUNTIME = {"ust_jaxrt": "ust_torchrt"}  # each package's runtime provider
#: kernel rows only the port records: its dense prefill attends through the
#: flash kernel, where the JAX dense family runs plain jnp attention
PORT_ONLY_KERNELS = {"h2o-danube-1.8b": {"flash_attention"}}


class CountingPolicy:
    """Counts the ticks that reach it; turns no knob."""

    name = "counting"

    def __init__(self):
        self.ticks = 0

    def tick(self, ctx) -> None:
        self.ticks += 1


class ModeFlipPolicy(CountingPolicy):
    """Moves the session to ``mode`` on its second tick."""

    name = "mode-flip"

    def __init__(self, mode: str):
        super().__init__()
        self.mode = mode

    def tick(self, ctx) -> None:
        super().tick(ctx)
        if self.ticks == 2:
            ctx.set_mode(self.mode, "mid-run flip")


def wait_until(pred, timeout_s=10.0, period_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period_s)
    return pred()


def _decode_calls(t) -> int:
    st = None if t is None else t.apis.get(("ust_repro", "decode_step"))
    return 0 if st is None else st.calls


def _live_after(eng, steps: int):
    """The engine's live tally once it has caught up with ``steps`` decode
    steps: the consumer thread drains and pushes on its own cadence."""
    assert wait_until(lambda: _decode_calls(eng.live_tally()) == steps)
    return eng.live_tally()


def _host_calls(t) -> dict:
    return {(RUNTIME.get(p, p), a): s.calls for (p, a), s in t.apis.items()}


def _totals(t) -> dict:
    return {
        **{k: (s.calls, s.total_ns) for k, s in t.apis.items()},
        **{("device",) + k: (s.calls, s.total_ns) for k, s in t.device_apis.items()},
    }


def _serve(pkg, model, params, prompts, out_dir, policy):
    """Serve ``prompts`` under a default-mode session with an in-process master;
    the engine ticks ``policy`` (period 0: every decode step)."""
    Tr, Cfg, Eng, SCfg, Ctrl = {
        "jax": (JaxTracer, JaxTraceConfig, JaxServeEngine, JaxServeConfig, JaxAdaptiveController),
        "torch": (Tracer, TraceConfig, ServeEngine, ServeConfig, AdaptiveController),
    }[pkg]
    ctrl = Ctrl([policy], period_s=0.0)
    eng = Eng(model, params, SCfg(**SERVE), adaptive=ctrl)
    reqs = [eng.submit(p) for p in prompts]
    steps = 0
    out = {"ctrl": ctrl, "policy": policy}
    cfg = Cfg(out_dir=out_dir, mode="default", serve_port=0, stream_period_s=0.02, flush_period_s=0.01)
    with Tr(cfg) as tr:
        while eng.step():
            steps += 1
            if steps == MID_RUN_STEPS:
                out["mid"] = _live_after(eng, steps)
        out["end"] = _live_after(eng, steps)
    out.update(tracer=tr, steps=steps, tokens=[r.out_tokens for r in reqs], final=tr.server.composite())
    return out


@pytest.fixture(scope="module", params=ARCHS)
def served(request, tmp_path_factory):
    arch = request.param
    jm = JaxModel(jax_get_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jm.cfg.vocab_size, size=(S,)) for S in PROMPT_LENS]
    runs = {
        "arch": arch,
        "jax": _serve("jax", jm, jp, prompts, str(tmp_path_factory.mktemp("jax")), CountingPolicy()),
        "torch": _serve("torch", tm, tp, prompts, str(tmp_path_factory.mktemp("torch")), CountingPolicy()),
    }
    runs["flip"] = _serve("torch", tm, tp, prompts, str(tmp_path_factory.mktemp("flip")),
                          ModeFlipPolicy("tally-only"))
    return runs


@pytest.mark.parametrize("when", ["mid", "end"])
def test_live_tally_has_the_jax_engines_apis_and_calls(served, when):
    j, t = served["jax"][when], served["torch"][when]
    assert _host_calls(t) == _host_calls(j)
    assert _decode_calls(t) == (MID_RUN_STEPS if when == "mid" else served["torch"]["steps"])
    port_only = PORT_ONLY_KERNELS.get(served["arch"], set())
    assert {a for _, a in t.device_apis} == {a for _, a in j.device_apis} | port_only
    assert served["torch"]["tokens"] == served["jax"]["tokens"]


def test_live_composite_equals_the_offline_tally(served):
    run = served["torch"]
    offline = tally_trace(run["tracer"].handle.trace_dir)
    assert _totals(run["final"]) == _totals(offline)
    assert _totals(run["tracer"].final_tally) == _totals(offline)


def test_engine_ticks_once_per_decode_step(served):
    for pkg in ("jax", "torch"):
        run = served[pkg]
        # the first tick only takes the baseline window
        assert run["ctrl"].ticks == run["policy"].ticks == run["steps"] - 1, pkg
    assert served["torch"]["steps"] == served["jax"]["steps"]


def test_a_mid_run_mode_change_leaves_the_tokens(served):
    flip = served["flip"]
    assert flip["tracer"].handle.fidelity == "tally-only"
    assert [a.knob for a in flip["ctrl"].actions] == ["fidelity"]
    assert flip["tokens"] == served["torch"]["tokens"] == served["jax"]["tokens"]
    assert flip["steps"] == served["torch"]["steps"]
    # the live tally keeps counting through the flip: every decode step
    assert _decode_calls(flip["end"]) == flip["steps"]
