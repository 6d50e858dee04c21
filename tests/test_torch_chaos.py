"""The port's chaos end-to-end runs, the twin of ``tests/test_chaos.py``
(``pytest -m chaos``), and of ``tests/test_stream.py::
test_two_rank_live_example_end_to_end``.

Each test launches ``python -m repro_torch.examples.distributed_train
--device cpu`` as a real subprocess tree: for ``--chaos`` a driver with a
MasterServer + ClusterAdaptiveController + RemediationEngine and N streaming
worker processes with a seeded FaultInjector; for ``--live`` two streaming
workers under a local and a global master.  The example checks itself (work
conservation, live == offline per rank, every decision traced, ladder order)
and exits non-zero on any failure; the assertions here pin the headline
invariants to stdout, so a regression reads as a specific missing line.
Every run has its own time limit."""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "repro_torch.examples.distributed_train"


def run_example(*args, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-m", MODULE, "--device", "cpu", *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, (
        f"run failed (exit {proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}"
    )
    return proc.stdout


def run_chaos(*extra, timeout=300):
    return run_example(
        "--chaos",
        "--chaos-ranks", "3",
        "--chaos-steps", "25",
        "--chaos-seed", "0",
        *extra,
        timeout=timeout,
    )


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_slowdown_walks_full_ladder():
    out = run_chaos("--inject-fault", "slowdown:rank=1,after=5,factor=8")
    assert "OK: ladder walked" in out
    assert "(drain before evict)" in out
    assert "steps re-dealt" in out
    assert "every one traced" in out
    assert "steps completed = 3 ranks" in out  # work conserved across eviction
    assert "FAIL" not in out


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_kill_recovers_from_checkpoint():
    out = run_chaos("--inject-fault", "kill:rank=2,after=8")
    assert "OK: ladder walked" in out
    assert "steps re-dealt" in out  # the dead rank's remainder went to survivors
    assert "every one traced" in out
    # the killed rank never flushed an on-disk aggregate; the example must
    # notice and skip it rather than fail the live-vs-offline comparison
    assert "no offline aggregate (died mid-run), skipped" in out
    assert "FAIL" not in out


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_dry_run_advises_without_touching():
    out = run_chaos(
        "--inject-fault", "slowdown:rank=0,after=3,factor=8", "--chaos-dry-run"
    )
    assert "OK: dry-run — full ladder advised, nothing touched" in out
    assert "every one traced" in out
    assert "[dry-run]" in out  # the advisory decisions themselves were printed
    assert "FAIL" not in out


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_no_fault_baseline_is_quiet():
    out = run_chaos()
    assert "steps completed = 3 ranks" in out
    assert "0 remediation decisions" in out
    assert "FAIL" not in out


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_kill_then_replace_elastic():
    """A killed rank is replaced, not evicted: the replacement admitted
    within the remediation budget, 3/3 healthy ranks at exit, work conserved
    through deal → splice → claw-back, live tally == offline fold per rank,
    and a zombie frame from the dead incarnation fenced with its poison row
    absent from the composite."""
    out = run_chaos(
        "--chaos-replace",
        "--inject-fault", "kill:rank=1,after=8",
        "--chaos-timeout", "90",
        timeout=180,
    )
    assert "replace_admit" in out
    assert "(drain before replace, no eviction)" in out
    assert "3/3 ranks healthy at exit" in out
    assert "steps completed = 3 ranks" in out  # work conserved through splice
    assert "1 replacement admitted" in out
    assert "zombie fenced (fence_rejects=" in out
    assert "poison row absent from the composite" in out
    assert "every one traced" in out
    assert "FAIL" not in out


@pytest.mark.slow
def test_two_rank_live_example_end_to_end():
    """``--live``: two local ranks stream through a local master to a global
    master (one rank deliberately slowed); the live composite matches the
    offline combine of the same run, per-rank sums equal the composite, and
    the cluster-scope StragglerRankPolicy flags the slow rank (advisory
    recorded + trainer-layer watchdog fed)."""
    out = run_example("--live", "--live-steps", "6", "--live-slow-rank", "1", timeout=180)
    assert "live composite matches offline combine" in out
    assert "per-rank sums equal the merged composite" in out
    assert "OK: straggler" in out and "rank1 flagged" in out
