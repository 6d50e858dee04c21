"""PyTorch port, the offline tracing core against the JAX package.

On a trace the port's CPU serving writes at smoke width, the port's and the
JAX package's ``pretty`` lines, ``validate`` findings, ``timeline`` JSON,
``.ctfcol`` sidecar bytes and aggregate tallies are equal, exactly; the
online analyzer's and the tally-only rung's final tallies equal the offline
tally.  Also the port's twins of the JAX package's columnar, aggregate,
validate, user-API and §1.1 memcpy tests — among them the stale-sidecar
case that the reference reader fails and the port's reader passes.
"""

import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from repro.core.aggregate import load_tally as jax_load_tally
from repro.core.aggregate import save_tally as jax_save_tally
from repro.core.ctf import build_sidecars as jax_build_sidecars
from repro.core.plugins.pretty import pretty_print as jax_pretty_print
from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro.core.plugins.timeline import query_intervals as jax_query_intervals
from repro.core.plugins.timeline import timeline_events as jax_timeline_events
from repro.core.plugins.validate import validate_trace as jax_validate_trace
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core import (
    TracedStep,
    TraceConfig,
    Tracer,
    kernel_span,
    record_alloc,
    traced_device_get,
    traced_device_put,
)
from repro_torch.core.aggregate import (
    aggregate_tree,
    combine_aggregates,
    find_aggregates,
    load_tally,
    merge_tallies,
    save_tally,
)
from repro_torch.core.clock import ClockInfo
from repro_torch.core.ctf import (
    COL_HEADER,
    COL_MAGIC,
    COL_VERSION,
    StreamWriter,
    build_sidecars,
    load_sidecar,
    sidecar_path,
    stream_files,
    write_metadata,
)
from repro_torch.core.fold import fold_trace
from repro_torch.core.plugins.pretty import pretty_print
from repro_torch.core.plugins.tally import ApiStat, Tally, tally_trace
from repro_torch.core.plugins.timeline import query_intervals, timeline_events, write_timeline
from repro_torch.core.plugins.validate import render as render_findings
from repro_torch.core.plugins.validate import validate_trace
from repro_torch.core.tracepoints import FIDELITY_MODES
from repro_torch.examples.trace_and_tally import memcpy_rows
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine
from tests.test_fold import _BYNAME, _MODEL, _U32, _U64, _build_trace, _pstr, _rec, canon

PROMPT_LENS = (8, 16, 8)
SERVE = dict(batch_slots=2, cache_len=32, max_new_tokens=4)


def _serve(trace_dir: str, arch: str = "mamba2-1.3b", **knobs) -> Tracer:
    """The port's CPU serving at smoke width under a default-mode trace."""
    model = Model(get_config(arch).smoke())
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(**SERVE))
    rng = np.random.default_rng(3)
    for S in PROMPT_LENS:
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=(S,)))
    with Tracer(TraceConfig(out_dir=trace_dir, mode="default", **knobs)) as tr:
        eng.run_until_drained()
    return tr


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(trace dir, tracer) of one serving session with the online analyzer on."""
    d = str(tmp_path_factory.mktemp("served"))
    return d, _serve(d, online=True)


def _calls(t: Tally) -> dict:
    return {
        **{k: s.calls for k, s in t.apis.items()},
        **{("device",) + k: s.calls for k, s in t.device_apis.items()},
    }


# ---------------------------------------------------------------------------
# The port's plugins against the JAX package's, on a port trace
# ---------------------------------------------------------------------------


def test_pretty_lines_equal_the_jax_packages(served):
    d, _ = served
    ours, theirs = io.StringIO(), io.StringIO()
    n = pretty_print(d, out=ours)
    assert n > 0 and n == jax_pretty_print(d, out=theirs)
    assert ours.getvalue() == theirs.getvalue()
    assert "ust_repro:prefill_entry" in ours.getvalue()
    filt = io.StringIO()
    assert pretty_print(d, out=filt, limit=3, name_filter="decode_step") == 3


def test_validate_findings_equal_the_jax_packages(served):
    d, _ = served
    ours = [tuple(vars(f).values()) for f in validate_trace(d)]
    assert ours == [tuple(vars(f).values()) for f in jax_validate_trace(d)]
    assert not [f for f in ours if f[0] == "error"]
    assert render_findings(validate_trace(d)).startswith("validation:")


def test_timeline_json_equals_the_jax_packages(served, tmp_path):
    d, _ = served
    ev = timeline_events(d)
    assert ev and ev == jax_timeline_events(d)
    path = str(tmp_path / "tl.json")
    assert write_timeline(d, path) == len(ev)
    doc = json.load(open(path))
    assert doc["traceEvents"] == json.loads(json.dumps(ev))
    names = {e["name"] for e in ev if e["ph"] == "X"}
    assert "ust_repro:decode_step" in names and "ssd_scan" in names


def test_sidecar_bytes_and_queries_equal_the_jax_packages(served, tmp_path):
    d, _ = served
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(d, a)
    shutil.copytree(d, b)
    n = build_sidecars(a)
    assert n == jax_build_sidecars(b) == len(stream_files(a))
    for p in stream_files(a):
        q = os.path.join(b, os.path.basename(p))
        assert open(sidecar_path(p), "rb").read() == open(sidecar_path(q), "rb").read()
    assert query_intervals(a) == jax_query_intervals(b, use_sidecar=False)
    assert canon(tally_trace(a)) == canon(jax_tally_trace(b, use_sidecar=False))


def test_aggregates_equal_and_cross_read(served, tmp_path):
    d, _ = served
    ours, theirs = tally_trace(d), jax_tally_trace(d)
    p, q = str(tmp_path / "port.tally"), str(tmp_path / "jax.tally")
    assert save_tally(ours, p) == jax_save_tally(theirs, q)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert canon(jax_load_tally(p)) == canon(load_tally(q)) == canon(ours)
    comp = combine_aggregates(find_aggregates(str(tmp_path)))
    assert _calls(comp) == {k: 2 * v for k, v in _calls(ours).items()}


def test_online_final_tally_equals_the_offline_tally(served):
    d, tr = served
    assert tr.final_tally is not None
    assert canon(tr.final_tally) == canon(tally_trace(d)) == canon(jax_tally_trace(d))


def test_tally_only_final_tally_equals_the_offline_tally(served, tmp_path):
    d, _ = served
    tr = _serve(str(tmp_path / "t"), fidelity="tally-only")
    assert not stream_files(tr.cfg.out_dir)
    assert _calls(tr.final_tally) == _calls(tally_trace(d))
    assert _calls(load_tally(tr.handle.aggregate_path)) == _calls(tally_trace(d))


# ---------------------------------------------------------------------------
# Columnar sidecars (twins of tests/test_columnar.py)
# ---------------------------------------------------------------------------


def _assert_roundtrip(trace_dir: str) -> None:
    """Columnar reads == record-parse reads, tallies and interval queries."""
    ref_tally = canon(fold_trace(trace_dir, use_sidecar=False))
    ref_rows = query_intervals(trace_dir, use_sidecar=False)
    assert canon(fold_trace(trace_dir, use_sidecar=True)) == ref_tally
    assert query_intervals(trace_dir, use_sidecar=True) == ref_rows
    if ref_rows:
        mid = ref_rows[len(ref_rows) // 2][0]
        for begin, end in ((None, mid), (mid, None), (mid // 2, mid * 2 + 1)):
            assert query_intervals(trace_dir, begin, end, use_sidecar=True) == query_intervals(
                trace_dir, begin, end, use_sidecar=False
            )


@pytest.mark.parametrize("seed", range(8))
def test_columnar_roundtrip_seeded(tmp_path, seed):
    d = str(tmp_path / "t")
    _build_trace(seed, d)
    assert build_sidecars(d) == len(stream_files(d))
    _assert_roundtrip(d)


def test_columnar_unmatched_and_discard_rows(tmp_path):
    from repro_torch.core.api_model import DISCARD_EVENT_ID

    d = str(tmp_path / "t")
    os.makedirs(d)
    ev_in, ev_out = _BYNAME["ust_a:alpha_entry"], _BYNAME["ust_a:alpha_exit"]
    launch = _BYNAME["ust_a:launch_span"]
    w = StreamWriter(os.path.join(d, "stream_5_6.ctf"), 5, 6)
    w.append(_rec(ev_out.eid, 50, _U32.pack(0)))  # unmatched exit
    w.append(_rec(ev_in.eid, 100, _U32.pack(1)))
    w.append(_rec(ev_out.eid, 175, _U32.pack(0)))  # pairs: dur 75
    w.append(_rec(launch.eid, 200, _U64.pack(200) + _U64.pack(230) + _pstr("k_q") + _U64.pack(1)))
    w.append(_rec(ev_in.eid, 300, _U32.pack(2)))  # never exits
    w.append(_rec(DISCARD_EVENT_ID, 400, _U64.pack(3)))
    w.close()
    write_metadata(d, _MODEL, ClockInfo.capture(), env={})
    build_sidecars(d)
    _assert_roundtrip(d)
    rows = query_intervals(d)
    assert (100, 75, 5, 6, "ust_a:alpha", False) in rows
    assert (200, 30, 5, 6, "k_q", True) in rows
    assert (300, 0, 5, 6, "ust_a:alpha", False) in rows  # flushed entry
    assert not [r for r in rows if r[0] == 50]  # unmatched exit: none
    assert fold_trace(d).discarded == 3


def _traced_dir(tmp_path, name, **cfg_kw):
    d = str(tmp_path / name)
    step = TracedStep(lambda x: (x * 3).sum(), name="triple_sum", device="cpu")
    x = torch.arange(64.0)
    with Tracer(TraceConfig(out_dir=d, mode="default", columnar=True, **cfg_kw)):
        for _ in range(3):
            step(x)
            with kernel_span("k_t", grid=(2,), flops=64, bytes_accessed=256):
                pass
    return d


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "compressed"])
def test_tracer_columnar_writes_valid_sidecars(tmp_path, compress):
    """Staleness keys on the container's size, so compression works too."""
    d = _traced_dir(tmp_path, "t", compress=compress)
    paths = stream_files(d)
    assert paths
    for p in paths:
        sc = load_sidecar(p)
        assert sc is not None and sc.footer["stream_bytes"] == os.path.getsize(p)
    _assert_roundtrip(d)
    assert tally_trace(d).device_apis[("ust_kernel", "k_t")].calls == 3


def test_tracer_aggregate_only_prunes_sidecars(tmp_path):
    d = _traced_dir(tmp_path, "t", aggregate_only=True)
    assert [n for n in os.listdir(d) if n.endswith((".ctf", ".ctfcol"))] == []
    t = load_tally(os.path.join(d, "aggregate_rank0.tally"))
    assert t.apis[("ust_torchrt", "dispatch")].calls == 3


def test_stale_sidecar_truncated_stream(tmp_path):
    d = str(tmp_path / "t")
    _build_trace(9, d)
    build_sidecars(d)
    p0 = stream_files(d)[0]
    with open(p0, "r+b") as f:
        f.truncate(os.path.getsize(p0) - 7)
    assert load_sidecar(p0) is None
    _assert_roundtrip(d)


def test_stale_sidecar_appended_stream(tmp_path):
    """The reference reader fails here on a compressed stream (ROADMAP fault
    16): the port reads the record appended after the compressed frame."""
    d = str(tmp_path / "t")
    _build_trace(10, d)
    build_sidecars(d)
    p0 = stream_files(d)[0]
    before = fold_trace(d, use_sidecar=False)
    with open(p0, "ab") as f:
        f.write(_rec(_BYNAME["ust_a:alpha_entry"].eid, 99_999, _U32.pack(1)))
    assert load_sidecar(p0) is None
    _assert_roundtrip(d)
    after = fold_trace(d, use_sidecar=False)
    key = ("ust_a", "alpha")
    assert after.apis[key].calls == before.apis[key].calls + 1  # the appended entry is read
    build_sidecars(d)  # re-indexing revalidates
    assert load_sidecar(p0) is not None
    _assert_roundtrip(d)


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "compressed"])
def test_appended_record_is_read_after_either_container(tmp_path, compress):
    d = str(tmp_path / "t")
    os.makedirs(d)
    ev_in, ev_out = _BYNAME["ust_a:alpha_entry"], _BYNAME["ust_a:alpha_exit"]
    w = StreamWriter(os.path.join(d, "stream_5_6.ctf"), 5, 6, compress=compress)
    w.append(_rec(ev_in.eid, 100, _U32.pack(1)))
    w.close()
    write_metadata(d, _MODEL, ClockInfo.capture(), env={})
    with open(w.path, "ab") as f:
        f.write(_rec(ev_out.eid, 175, _U32.pack(0)))
    assert query_intervals(d) == [(100, 75, 5, 6, "ust_a:alpha", False)]


def test_missing_sidecar_is_silent_fallback(tmp_path):
    d = str(tmp_path / "t")
    _build_trace(12, d)
    build_sidecars(d)
    os.unlink(sidecar_path(stream_files(d)[0]))
    _assert_roundtrip(d)


def test_unknown_sidecar_version_skipped(tmp_path):
    d = str(tmp_path / "t")
    _build_trace(13, d)
    build_sidecars(d)
    p0 = stream_files(d)[0]
    with open(sidecar_path(p0), "r+b") as f:
        f.write(COL_HEADER.pack(COL_MAGIC, COL_VERSION + 1, 0))
    assert load_sidecar(p0) is None
    _assert_roundtrip(d)


def test_garbage_sidecar_never_crashes(tmp_path):
    d = str(tmp_path / "t")
    _build_trace(15, d)
    build_sidecars(d)
    for i, p in enumerate(stream_files(d)):
        with open(sidecar_path(p), "wb") as f:
            f.write(os.urandom(40 + i) + struct.pack("<I", 7))
        assert load_sidecar(p) is None
    _assert_roundtrip(d)


# ---------------------------------------------------------------------------
# Aggregation (twins of tests/test_aggregate.py)
# ---------------------------------------------------------------------------


def _rank_tally(rank: int, calls: int = 10) -> Tally:
    t = Tally()
    t.hostnames.add(f"node{rank // 8:03d}")
    t.processes.add(rank)
    t.threads.add((rank, 1))
    s = ApiStat()
    for i in range(calls):
        s.add(1000 + rank + i)
    t.apis[("ust_repro", "decode_step")] = s
    k = ApiStat()
    k.add(50 * (rank + 1))
    t.device_apis[("ust_kernel", "rglru_scan")] = k
    return t


@pytest.mark.parametrize("fanout", [2, 8, 32, 600])
def test_tree_merge_is_independent_of_fanout(fanout):
    flat = Tally()
    for r in range(100):
        flat.merge(_rank_tally(r, calls=3))
    comp, stats = merge_tallies([_rank_tally(r, calls=3) for r in range(100)], fanout=fanout)
    assert canon(comp) == canon(flat)
    assert stats.messages == 99 and stats.leaves == 100


def test_save_load_roundtrip_is_kilobytes(tmp_path):
    t = _rank_tally(7)
    t.discarded = 5
    p = str(tmp_path / "r7.tally")
    assert save_tally(t, p) < 4096  # "typically in the range of kilobytes" (§3.7)
    assert load_tally(p).to_obj() == t.to_obj()


def test_aggregate_tree_empty_raises():
    with pytest.raises(ValueError):
        aggregate_tree([], lambda a, b: a)


# ---------------------------------------------------------------------------
# Validation, the user API and the §1.1 memcpy example
# ---------------------------------------------------------------------------


def test_validate_detects_unreleased_alloc_and_zero_copy(tmp_path):
    d = str(tmp_path / "v")
    with Tracer(TraceConfig(out_dir=d)):
        record_alloc(1 << 20)
        traced_device_put(np.zeros(0, np.float32), "cpu")
    rules = {f.rule for f in validate_trace(d)}
    assert {"unreleased_alloc", "zero_copy"} <= rules


def test_validate_detects_unmatched_entry(tmp_path):
    d = str(tmp_path / "open")
    with Tracer(TraceConfig(out_dir=d)) as tr:
        tr.tp.record["ust_repro:prefill_entry"](0, 1, 1)  # never exits
    assert "unmatched_entry" in {f.rule for f in validate_trace(d)}


def test_memcpy_rows_deduce_the_direction_from_pointer_classes(tmp_path):
    d = str(tmp_path / "m")
    x = np.arange(1024, dtype=np.float32)
    with Tracer(TraceConfig(out_dir=d, mode="full")):
        dev = traced_device_put(x, "cpu")
        back = traced_device_get(dev * 2)
    assert np.array_equal(back, x * 2)
    kinds = [k for _, k in memcpy_rows(d) if k is not None]
    assert kinds == ["H2D", "D2H"]
    lines = [line for line, _ in memcpy_rows(d)]
    assert "nbytes: 4096" in lines[0] and "dst: 0xff" in lines[0] and "src: 0xff" in lines[2]
    t = tally_trace(d)
    assert t.apis[("ust_torchrt", "memcpy")].calls == 2
    assert t.device_apis[("ust_kernel", "transfer")].calls == 2


def test_memcpy_is_a_passthrough_without_a_session():
    x = np.ones(8, np.float32)
    assert np.array_equal(traced_device_get(traced_device_put(x, "cpu")), x)


def test_user_api_annotates_phases_and_moves_the_rung(tmp_path):
    d = str(tmp_path / "api")
    with Tracer(TraceConfig(out_dir=d, mode="full")):
        assert trace.get_mode() == "full"
        assert trace.annotate("marker", step=1)
        with trace.phase("warm"):
            pass
        assert trace.set_mode("sampled") == "full" and trace.get_mode() == "sampled"
        assert trace.set_mode("tally-only") == "sampled"
        trace.set_mode("full")
        with pytest.raises(ValueError):
            trace.set_mode("bogus")
    assert trace.get_mode() is None
    assert not trace.annotate("no_session")
    with pytest.raises(RuntimeError):
        trace.set_mode("off")
    assert ("ust_user", "phase") in tally_trace(d).apis
    assert trace.FIDELITY_MODES == FIDELITY_MODES == ("full", "sampled", "tally-only", "off")
