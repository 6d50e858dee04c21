"""PyTorch port, tracing core and interception against the JAX package.

A trace the port writes tallies the same under the JAX ``tally_trace`` and
the port's own; a traced port serving run records the same framework rows as
the JAX one, and for each model family the same dispatch payloads (argument
bytes, and the donated decode cache's bytes); the decode step writes the
engine's cache in place; the port's trace model extends the JAX builtin
model eid for eid; shared events encode byte for byte alike.  Also the port's guards: no
JAX or ``repro`` import anywhere in the port, no CPU fallback in the
launcher; the live-tracing knobs and the remediation engine start a session.
The offline knobs (online tally, aggregate-only, columnar sidecars, the
tally-only rung) tally a serving session as the JAX package's do.
"""

import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.aggregate import load_tally as jax_load_tally
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
from repro_torch.core.aggregate import load_tally
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
    """One traced Mamba2 serving run per package (default mode), same weights and prompts."""
    return _served("mamba2-1.3b", tmp_path_factory)


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


def _served(arch, tmp_path_factory, prompt_lens=PROMPT_LENS, knobs=None, tracers=None):
    """One traced serving run of ``arch``'s smoke model per package (default
    mode, and the TraceConfig ``knobs``), same weights and prompts:
    {package: (trace dir, tokens)}; each package's Tracer goes into
    ``tracers`` when it is given."""
    jm = JaxModel(jax_get_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jm.cfg.vocab_size, size=(S,)) for S in prompt_lens]
    out = {}
    for name, (Tr, Cfg, Eng, SCfg, model, params) in {
        "jax": (JaxTracer, JaxTraceConfig, JaxServeEngine, JaxServeConfig, jm, jp),
        "torch": (Tracer, TraceConfig, ServeEngine, ServeConfig, tm, tp),
    }.items():
        d = str(tmp_path_factory.mktemp(f"serve_{name}"))
        eng = Eng(model, params, SCfg(**SERVE))
        reqs = [eng.submit(p) for p in prompts]
        with Tr(Cfg(out_dir=d, mode="default", **(knobs or {}))) as tr:
            eng.run_until_drained()
        out[name] = (d, [r.out_tokens for r in reqs])
        if tracers is not None:
            tracers[name] = tr
    return out


@pytest.fixture(scope="module", params=["recurrentgemma-2b", "h2o-danube-1.8b", "moonshot-v1-16b-a3b",
                                        "whisper-medium"])
def family_traces(request, tmp_path_factory):
    return _served(request.param, tmp_path_factory)


def _dispatch_rows(source_cls, trace_dir) -> set:
    """(fn, nargs, arg_bytes, donated_bytes) of every dispatch entry of a trace."""
    keys = ("fn", "nargs", "arg_bytes", "donated_bytes")
    return {
        tuple(e.field(k) for k in keys) for e in source_cls(trace_dir) if e.name.endswith(":dispatch_entry")
    }


def _check_dispatch_rows(served):
    """The port's dispatch rows carry the JAX engine's payloads: the decode
    row donates the whole cache, whose bytes it records (int32 tokens on
    both sides), and the prefill rows donate nothing."""
    (jd, jtoks), (td, ttoks) = served["jax"], served["torch"]
    assert ttoks == jtoks
    got, want = _dispatch_rows(CTFSource, td), _dispatch_rows(JaxCTFSource, jd)
    assert got == want
    decode = [r for r in got if r[0].startswith("decode_step[")]
    assert len(decode) == 1 and 0 < decode[0][3] < decode[0][2]
    prefill = [r for r in got if r[0].startswith("prefill[")]
    assert len(prefill) == len(set(PROMPT_LENS)) and all(r[3] == 0 for r in prefill)


def test_dispatch_rows_carry_the_jax_engines_bytes(traces):
    _check_dispatch_rows(traces)


def test_dispatch_rows_of_the_other_families_carry_the_jax_engines_bytes(family_traces):
    _check_dispatch_rows(family_traces)


@pytest.mark.parametrize("arch,dtype", [
    ("mamba2-1.3b", "float32"),
    ("recurrentgemma-2b", "float32"),
    ("h2o-danube-1.8b", "float32"),
    ("mamba2-1.3b", "bfloat16"),
    ("recurrentgemma-2b", "bfloat16"),
    ("h2o-danube-1.8b", "bfloat16"),
    ("moonshot-v1-16b-a3b", "float32"),
    ("whisper-medium", "float32"),
    ("moonshot-v1-16b-a3b", "bfloat16"),
    ("whisper-medium", "bfloat16"),
])
def test_decode_step_writes_the_engines_cache_in_place(arch, dtype):
    """Every cache leaf keeps its storage from step to step, and the decode
    step returns the cache it was handed.  A bf16 RecurrentGemma cache
    declares h in bf16 and the RG-LRU gives it in fp32, so the first step
    turns those leaves fp32, as the JAX step's output does, once."""
    import dataclasses

    model = Model(dataclasses.replace(get_config(arch).smoke(), dtype=dtype))
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(batch_slots=2, cache_len=32, max_new_tokens=5))
    for p in _prompts(model.cfg.vocab_size):
        eng.submit(p)
    cache = eng.cache

    def ptrs():
        out = []
        stack = [cache]
        while stack:
            t = stack.pop()
            if isinstance(t, torch.Tensor):
                out.append(t.data_ptr())
            else:
                stack.extend(t.values() if isinstance(t, dict) else t)
        return out

    eng.step()
    after_first = ptrs()
    while eng.step() or eng.queue:
        assert eng.cache is cache and ptrs() == after_first
    assert len(eng.completed) == len(PROMPT_LENS)
    logits, out = model.decode_step(params, cache, {"token": torch.zeros(2, dtype=torch.int32)})
    assert out is cache and ptrs() == after_first


def test_serve_config_takes_the_jax_keywords():
    import dataclasses

    fields = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert fields == {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    kw = dict(batch_slots=2, cache_len=64, max_new_tokens=3, eos_id=7, greedy=True)
    assert dataclasses.asdict(ServeConfig(**kw)) == dataclasses.asdict(JaxServeConfig(**kw))


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
        r["ust_jaxrt:dispatch_entry"]("step", 3, 1 << 20, 1 << 19)
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


COLLECTIVES = [("all_reduce", 4096, "data", 2), ("all_gather", 512, "model", 4),
               ("reduce_scatter", 1024, "data", 8), ("all_to_all", 2048, "expert", 4),
               ("broadcast", 64, "", 2), ("barrier", 0, "step", 3)]


def test_collective_span_records_what_the_jax_span_records(tmp_path):
    """Each kind of ``collective_span`` in both packages: the same event ids
    and payloads, and the same device rows under the JAX ``tally_trace``;
    without a session the span records nothing."""
    from repro.core.interception import collective_span as jax_collective_span
    from repro_torch.core import collective_span

    with collective_span("all_reduce", 8, "data", 2):  # no session: a no-op
        pass
    dirs = {}
    for name, tracer, cfg, span in (("jax", JaxTracer, JaxTraceConfig, jax_collective_span),
                                    ("torch", Tracer, TraceConfig, collective_span)):
        dirs[name] = str(tmp_path / name)
        with tracer(cfg(out_dir=dirs[name], mode="default")):
            for args in COLLECTIVES:
                with span(*args):
                    pass

    def rows(d):
        out = []
        for e in JaxCTFSource(d):
            if e.etype.provider == "ust_collective":
                f = e.asdict()
                f.pop("ts_begin"), f.pop("ts_end")
                out.append((e.etype.eid, e.etype.api, f))
        return out

    assert len(rows(dirs["torch"])) == len(COLLECTIVES)
    assert rows(dirs["torch"]) == rows(dirs["jax"])

    def calls(t):
        return {k: st.calls for k, st in t.device_apis.items()}

    want = calls(jax_tally_trace(dirs["jax"]))
    assert len(want) == len(COLLECTIVES)
    assert calls(jax_tally_trace(dirs["torch"])) == want == calls(tally_trace(dirs["torch"]))


def test_traced_step_is_a_passthrough_without_a_session():
    step = TracedStep(lambda x: x + 1, device="cpu")
    assert torch.equal(step(torch.zeros(2)), torch.ones(2))


@pytest.mark.parametrize(
    "knob,value",
    [
        ("stream_to", "localhost:1"),
        ("serve_port", 0),
        ("adaptive", []),
        ("cluster_adaptive", []),
        ("remediation", "engine"),
    ],
)
def test_unported_trace_knobs_raise(tmp_path, knob, value):
    """No knob raises any more: the live-tracing knobs start a session
    (``cluster_adaptive`` with the in-process master it reads), a
    ``remediation`` engine is attached to it and ticked by the consumer
    thread, and the tally, offline, counts the traced step."""
    if knob == "remediation":
        from repro_torch.core import RemediationEngine

        value = RemediationEngine(cooldown_s=0.01, backoff_cap_s=0.01, escalate_after=1)
    extra = {"serve_port": 0} if knob == "cluster_adaptive" else {}
    cfg = TraceConfig(out_dir=str(tmp_path), **{knob: value}, **extra)
    assert cfg.online == (knob != "remediation")  # every live knob implies the live tally
    step = TracedStep(lambda x: x * 2, name="double", device="cpu")
    with Tracer(cfg) as tr:
        step(torch.ones(4))
        assert (tr.streamer is not None) == (knob == "stream_to")
        assert (tr.server is not None) == (knob in ("serve_port", "cluster_adaptive"))
        assert (tr.adaptive is not None) == (knob == "adaptive")
        assert tr.cluster is None or tr.cluster.master is tr.server
        assert (tr.remediation is value) == (knob == "remediation")
        if knob == "remediation":  # the consumer thread's ticks walk the ladder
            value.ingest_flag("rank0", "straggler", "test")
            deadline = time.monotonic() + 10.0
            while not value.actions and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [a.action for a in value.actions] == ["escalate_fidelity"]
    if knob == "stream_to":  # nothing listens there: every push is dropped
        assert tr.handle.streamed == 0 and tr.handle.stream_dropped >= 1
    if cfg.online:
        assert tr.final_tally.device_apis[("ust_kernel", "double")].calls == 1
    assert tally_trace(str(tmp_path)).device_apis[("ust_kernel", "double")].calls == 1


def _knob_tally(knob, tracer, trace_dir, load, tally):
    """What a session with ``knob`` leaves to tally, read with its package's
    own ``load_tally`` / ``tally_trace``."""
    ctf = [f for f in os.listdir(trace_dir) if f.endswith(".ctf")]
    if knob in ("aggregate_only", "fidelity"):  # no stream left (pruned, or never written)
        assert not ctf and tracer.handle.aggregate_path
        return load(tracer.handle.aggregate_path)
    if knob == "columnar":
        assert ctf and all(os.path.exists(os.path.join(trace_dir, f + "col")) for f in ctf)
        return tally(trace_dir)  # through the sidecars
    return tracer.final_tally  # the online analyzer's, at stop()


@pytest.mark.parametrize(
    "knob,value",
    [("online", True), ("aggregate_only", True), ("columnar", True), ("fidelity", "tally-only")],
)
def test_offline_trace_knobs_tally_as_the_jax_package(tmp_path_factory, knob, value):
    """The same serving session under the same knob in both packages: the
    same framework rows, runtime rows (under each runtime's provider) and
    kernel names, and, for the knobs that keep the streams, the port's
    result equals the JAX package's analysis of the port's own streams."""
    tracers = {}
    served = _served("mamba2-1.3b", tmp_path_factory, knobs={knob: value}, tracers=tracers)
    (jd, jtoks), (td, ttoks) = served["jax"], served["torch"]
    assert ttoks == jtoks
    jt = _knob_tally(knob, tracers["jax"], jd, jax_load_tally, jax_tally_trace)
    tt = _knob_tally(knob, tracers["torch"], td, load_tally, tally_trace)
    for api in ("prefill", "decode_step"):
        assert tt.apis[("ust_repro", api)].calls == jt.apis[("ust_repro", api)].calls
    for api in ("dispatch", "compile"):
        assert tt.apis[("ust_torchrt", api)].calls == jt.apis[("ust_jaxrt", api)].calls
    assert {a for _, a in tt.device_apis} == {a for _, a in jt.device_apis}
    if knob in ("online", "columnar"):
        assert _norm(tt.to_obj()) == _norm(jax_tally_trace(td, use_sidecar=False).to_obj())


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
    rel = {os.path.relpath(p, os.path.join(ROOT, "src", "repro_torch")) for p in srcs}
    assert {"core/stream.py", "core/adaptive.py", "examples/serve_traced.py"} <= rel
    assert {"core/faults.py", "core/remediation.py", "launch/mesh.py", "launch/elastic.py",
            "examples/distributed_train.py"} <= rel
    assert {"tree.py", "optim/adamw.py", "optim/schedule.py", "optim/compression.py", "data/pipeline.py",
            "checkpoint/checkpointer.py", "train/train_step.py", "train/trainer.py", "launch/train.py",
            "examples/quickstart.py"} <= rel
    assert {"launch/roofline.py", "launch/dryrun.py"} <= rel
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
