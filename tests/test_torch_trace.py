"""PyTorch port, tracing core and interception against the JAX package.

A trace the port writes tallies the same under the JAX ``tally_trace`` and
the port's own; a traced port serving run records the same framework rows as
the JAX one; the port's trace model extends the JAX builtin model eid for
eid; shared events encode byte for byte alike.  Also the port's guards: no
JAX or ``repro`` import anywhere in the port, no CPU fallback in the
launcher, and an error for every tracing knob whose module is not ported.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.api_model import builtin_trace_model as jax_builtin_trace_model
from repro.core.babeltrace import CTFSource as JaxCTFSource
from repro.core.plugins.tally import render as jax_render
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.core.ringbuffer import RingRegistry as JaxRingRegistry
from repro.core.tracepoints import Tracepoints as JaxTracepoints
from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import TracedStep, TraceConfig, Tracer
from repro_torch.core.api_model import builtin_trace_model
from repro_torch.core.babeltrace import CTFSource
from repro_torch.core.plugins.tally import render, tally_trace
from repro_torch.core.ringbuffer import RingRegistry
from repro_torch.core.telemetry import read_device_memory
from repro_torch.core.tracepoints import Tracepoints
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LENS = (8, 16, 8)
SERVE = dict(batch_slots=2, cache_len=32, max_new_tokens=4)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, size=(S,)) for S in PROMPT_LENS]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One traced serving run per package (default mode), same weights and prompts."""
    jm = JaxModel(jax_get_config("mamba2-1.3b").smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("mamba2-1.3b").smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    out = {}
    for name, (Tr, Cfg, Eng, SCfg, model, params) in {
        "jax": (JaxTracer, JaxTraceConfig, JaxServeEngine, JaxServeConfig, jm, jp),
        "torch": (Tracer, TraceConfig, ServeEngine, ServeConfig, tm, tp),
    }.items():
        d = str(tmp_path_factory.mktemp(f"serve_{name}"))
        eng = Eng(model, params, SCfg(**SERVE))
        reqs = [eng.submit(p) for p in _prompts(model.cfg.vocab_size)]
        with Tr(Cfg(out_dir=d, mode="default")):
            eng.run_until_drained()
        out[name] = (d, [r.out_tokens for r in reqs])
    return out


def _norm(obj: dict) -> dict:
    return {k: sorted(v) if k in ("apis", "device_apis") else v for k, v in obj.items()}


def test_port_trace_tallies_alike_under_both_packages(traces):
    d, _ = traces["torch"]
    jt, tt = jax_tally_trace(d), tally_trace(d)
    assert _norm(jt.to_obj()) == _norm(tt.to_obj())
    assert jax_render(jt) == render(tt)
    assert jax_render(jt, device=True) == render(tt, device=True)


def test_serving_trace_matches_jax_framework_rows(traces):
    (jd, jtoks), (td, ttoks) = traces["jax"], traces["torch"]
    assert ttoks == jtoks
    jt, tt = jax_tally_trace(jd), tally_trace(td)
    for api in ("prefill", "decode_step"):
        assert tt.apis[("ust_repro", api)].calls == jt.apis[("ust_repro", api)].calls
    assert tt.apis[("ust_repro", "prefill")].calls == len(PROMPT_LENS)
    # the runtime layer under its own provider, with the same call counts
    for api in ("dispatch", "compile"):
        assert tt.apis[("ust_torchrt", api)].calls == jt.apis[("ust_jaxrt", api)].calls
    # kernel launches compare by name: JAX records one per trace, eager torch per call
    assert {a for _, a in tt.device_apis} == {a for _, a in jt.device_apis}
    n_layers = get_config("mamba2-1.3b").smoke().num_layers
    assert tt.device_apis[("ust_kernel", "ssd_scan")].calls == n_layers * len(PROMPT_LENS)


def _ssd_span_payloads(source_cls, trace_dir):
    keys = ("grid_x", "grid_y", "grid_z", "flops", "bytes_accessed")
    return {
        tuple(e.field(k) for k in keys)
        for e in source_cls(trace_dir)
        if e.name == "ust_kernel:launch_span" and e.field("name") == "ssd_scan"
    }


def test_ssd_spans_carry_the_jax_payloads(traces):
    """Same grid, FLOPs and bytes per prompt length as the JAX spans."""
    want = _ssd_span_payloads(JaxCTFSource, traces["jax"][0])
    got = _ssd_span_payloads(CTFSource, traces["torch"][0])
    assert len(want) == len(set(PROMPT_LENS)) and got == want


def test_trace_model_extends_jax_builtin_eid_for_eid():
    jm, tm = jax_builtin_trace_model().to_json(), builtin_trace_model().to_json()
    assert tm[: len(jm)] == jm
    extra = tm[len(jm):]
    assert extra and {e["provider"] for e in extra} == {"ust_torchrt"}
    jaxrt = [
        {k: v for k, v in e.items() if k not in ("eid", "name", "provider")}
        for e in jm if e["provider"] == "ust_jaxrt"
    ]
    assert [{k: v for k, v in e.items() if k not in ("eid", "name", "provider")} for e in extra] == jaxrt


def _ticking(start=1000, step=7):
    c = [start]

    def clock():
        c[0] += step
        return c[0]

    return clock


def _drive(tp_cls, model, reg_cls):
    tp = tp_cls(model, clock=_ticking())
    reg = reg_cls(1 << 16, pid=1)
    tp.attach(reg, range(len(model.events)))
    r, pair = tp.record, tp.record_pair
    for i in range(20):
        r["ust_repro:prefill_entry"](i, 1, 8 + i)
        r["ust_kernel:launch_span"](i, i + 5, "ssd_scan", 1, 4, 1, 10 * i, 20 * i)
        r["ust_repro:prefill_exit"](0)
        r["ust_repro:decode_step_entry"](i, 2, 32)
        pair["ust_repro:poll_ready"](2**40 + i, 5000 + i, i % 2 == 0)
        r["ust_repro:decode_step_exit"](0, 2)
        r["ust_jaxrt:dispatch_entry"]("step", 3, 1 << 20, 0)
        r["ust_jaxrt:dispatch_exit"](0)
    out = b"".join(ring.drain() for ring in reg.rings())
    tp.detach()
    return out


def test_shared_events_encode_byte_identically():
    a = _drive(JaxTracepoints, jax_builtin_trace_model(), JaxRingRegistry)
    b = _drive(Tracepoints, builtin_trace_model(), RingRegistry)
    assert a and a == b


def test_traced_step_records_compile_once_and_dispatch_per_call(tmp_path):
    step = TracedStep(lambda x: x * 2, name="double", device="cpu", flops=8)
    with Tracer(TraceConfig(out_dir=str(tmp_path), mode="full")):
        for _ in range(3):
            step(torch.ones(4))
    t = tally_trace(str(tmp_path))
    assert t.apis[("ust_torchrt", "compile")].calls == 1
    assert t.apis[("ust_torchrt", "dispatch")].calls == 3
    assert t.device_apis[("ust_kernel", "double")].calls == 3
    # a CPU step has finished when it returns: no fence rows
    assert ("ust_torchrt", "block_until_ready") not in t.apis
    assert ("ust_repro", "poll_ready") not in t.apis


def test_traced_step_is_a_passthrough_without_a_session():
    step = TracedStep(lambda x: x + 1, device="cpu")
    assert torch.equal(step(torch.zeros(2)), torch.ones(2))


@pytest.mark.parametrize(
    "knob,value",
    [
        ("online", True),
        ("stream_to", "localhost:1"),
        ("serve_port", 0),
        ("adaptive", []),
        ("cluster_adaptive", []),
        ("aggregate_only", True),
        ("columnar", True),
        ("remediation", object()),
        ("fidelity", "tally-only"),
    ],
)
def test_unported_trace_knobs_raise(tmp_path, knob, value):
    with pytest.raises(NotImplementedError, match="later slice"):
        TraceConfig(out_dir=str(tmp_path), **{knob: value})


def test_cpu_device_memory_reads_zero():
    assert read_device_memory("cpu") == (0, 0, 0)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))", re.M)


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    srcs = list(_port_sources())
    assert len(srcs) > 20
    bad = []
    for p in srcs:
        with open(p) as f:
            bad += [f"{p}: {m.group(0).strip()}" for m in _FORBIDDEN.finditer(f.read())]
    assert not bad, bad


def test_import_guard_catches_each_form():
    for line in ("import jax", "from jax import numpy", "import repro", "from repro.core import x",
                 "from repro import core", "    import jax.numpy as jnp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x", "# import jax"):
        assert not _FORBIDDEN.search(line), line


def test_launcher_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launcher.main([])


def test_launcher_serves_on_the_cpu_when_asked(tmp_path, capsys):
    rc = serve_launcher.main(
        ["--device", "cpu", "--requests", "3", "--new-tokens", "3", "--trace", "default",
         "--trace-dir", str(tmp_path)]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 3 requests, 9 tokens" in out
    assert "prefill" in out and "decode_step" in out
