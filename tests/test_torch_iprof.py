"""The port's ``iprof`` launcher and analyser, end to end, in process.

``iprof run`` launches the port's serving entry point on the CPU
(``repro_torch.launch.serve:main --device cpu`` at smoke width, the
launcher's own trace off, so the session is iprof's), then ``tally``,
``index``, ``pretty``, ``timeline``, ``validate`` and ``combine`` read what
it wrote.  The aggregate-only and tally-only runs of the same workload
tally the same calls as the offline tally; the JAX package's analysis of
the port's trace agrees with the port's.  The commands that need the
streaming masters raise.
"""

import json
import os
import re

import pytest

from repro.core.plugins.tally import tally_trace as jax_tally_trace
from repro_torch.core.aggregate import load_tally
from repro_torch.core.ctf import load_sidecar, stream_files
from repro_torch.core.iprof import main as iprof
from repro_torch.core.plugins.tally import tally_trace

TARGET = ["repro_torch.launch.serve:main", "--device", "cpu", "--requests", "3", "--new-tokens", "3"]


def _run(out: str, *flags: str) -> str:
    assert iprof(["run", "-m", "default", "-o", out, *flags, "--", *TARGET]) == 0
    return out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return _run(str(tmp_path_factory.mktemp("iprof") / "default"))


def _calls(t) -> dict:
    return {
        **{k: s.calls for k, s in t.apis.items()},
        **{("device",) + k: s.calls for k, s in t.device_apis.items()},
    }


def test_run_traces_the_launchers_session(run_dir):
    t = tally_trace(run_dir)
    assert t.apis[("ust_repro", "prefill")].calls == 3
    assert t.apis[("ust_torchrt", "compile")].calls == 2  # one prefill length, one decode step
    assert t.apis[("ust_torchrt", "dispatch")].calls == 3 + t.apis[("ust_repro", "decode_step")].calls
    assert _calls(t) == _calls(jax_tally_trace(run_dir))


def test_tally_renders_and_jobs_match_serial(run_dir, capsys):
    capsys.readouterr()
    assert iprof(["tally", run_dir]) == 0
    serial = capsys.readouterr().out
    assert "decode_step" in serial and "Time(%)" in serial and "-- device --" in serial
    assert iprof(["tally", run_dir, "--jobs", "2", "--no-sidecar"]) == 0
    assert capsys.readouterr().out == serial


def test_index_then_tally_is_unchanged(run_dir, tmp_path, capsys):
    import shutil

    d = str(tmp_path / "t")
    shutil.copytree(run_dir, d)
    capsys.readouterr()
    assert iprof(["tally", d]) == 0
    before = capsys.readouterr().out
    assert iprof(["index", d]) == 0
    assert "indexed" in capsys.readouterr().out
    assert all(load_sidecar(p) is not None for p in stream_files(d))
    assert iprof(["tally", d]) == 0
    assert capsys.readouterr().out == before


def test_pretty_timeline_validate(run_dir, tmp_path, capsys):
    capsys.readouterr()
    assert iprof(["pretty", run_dir, "-n", "20"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 20 and all("vpid" in line for line in lines)
    tl = str(tmp_path / "tl.json")
    assert iprof(["timeline", run_dir, "-o", tl]) == 0
    assert json.load(open(tl))["traceEvents"]
    assert iprof(["validate", run_dir]) == 0
    assert "[error]" not in capsys.readouterr().out


def test_tally_empty_trace_dir_warns(run_dir, tmp_path, capsys):
    import shutil

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    shutil.copy(os.path.join(run_dir, "metadata.json"), empty)
    capsys.readouterr()
    assert iprof(["tally", empty]) == 0
    cap = capsys.readouterr()
    assert "no completed streams" in cap.err and "0 Processes" in cap.out


def test_run_columnar_writes_sidecars(tmp_path):
    out = _run(str(tmp_path / "col"), "--columnar")
    assert stream_files(out) and all(load_sidecar(p) is not None for p in stream_files(out))


@pytest.mark.parametrize("flags", [["--aggregate-only"], ["--fidelity", "tally-only"]],
                         ids=["aggregate-only", "tally-only"])
def test_aggregate_runs_tally_the_offline_calls_and_combine(run_dir, tmp_path, capsys, flags):
    for r in range(2):
        _run(str(tmp_path / f"r{r}"), "--rank", str(r), *flags)
    for r in range(2):
        d = str(tmp_path / f"r{r}")
        assert not stream_files(d)
        agg = load_tally(os.path.join(d, f"aggregate_rank{r}.tally"))
        assert _calls(agg) == _calls(tally_trace(run_dir))
    capsys.readouterr()
    assert iprof(["combine", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    m = re.search(r"prefill\s*\|\s+[\d.]+\w*\s+\|\s+[\d.]+%\s+\|\s+(\d+)\s+\|", text)
    assert m and int(m.group(1)) == 6, text


@pytest.mark.parametrize("argv", [
    ["serve", "--port", "0"],
    ["top", "127.0.0.1:1"],
    ["run", "-o", "OUT", "--stream-to", "127.0.0.1:1", "--", *TARGET],
    ["run", "-o", "OUT", "--serve-port", "0", "--", *TARGET],
])
def test_live_commands_raise(tmp_path, argv):
    argv = [str(tmp_path / "t") if a == "OUT" else a for a in argv]
    with pytest.raises(NotImplementedError, match="item 2, live tracing"):
        iprof(argv)
