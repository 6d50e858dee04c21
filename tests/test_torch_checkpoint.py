"""PyTorch port, the checkpointer: twins of the JAX package's checkpointer
tests (``test_train_serve.py``, and the damage and async-commit cases of
``test_resilience.py``), checkpoints carried between the two packages, and
bf16 leaves.

The on-disk format is the JAX one: ``step_<n>/`` written through
``step_<n>.tmp/``, one ``.npy`` a leaf, ``manifest.json`` with key, file,
shape, dtype, crc32 and nbytes.  fp32 state written by either package
restores under the other exactly.  numpy has no bfloat16: the port writes a
bf16 leaf as its 16-bit words with ``"dtype": "bfloat16"`` and restores it
bit for bit, and it reads the JAX package's bf16 leaves (``ml_dtypes``
arrays, which ``np.load`` returns as 2-byte voids) the same way.  The JAX
checkpointer restores neither as bfloat16 (ROADMAP fault 24).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer, latest_checkpoint, list_checkpoints
from repro_torch.convert import state_from_jax
from repro_torch.core import TraceConfig, Tracer


def test_checkpointer_integrity_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3))}}
    path = ck.save(5, state)
    target = os.path.join(path, "b__c.npy")
    arr = np.load(target)
    arr[0, 0] = 777.0
    np.save(target, arr)
    with pytest.raises(ValueError, match="integrity"):
        ck.restore(path, state)


def test_checkpointer_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.zeros(2)})
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    assert latest_checkpoint(str(tmp_path)).endswith("step_4")


def test_checkpointer_async(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"a": torch.arange(4.0)}
    ck.save_async(1, state, extra={"data": {"step": 1}})
    state["a"].fill_(-1.0)  # the snapshot was taken before the call returned
    ck.wait()
    restored, man = ck.restore(latest_checkpoint(str(tmp_path)), {"a": torch.zeros(4)})
    np.testing.assert_allclose(restored["a"].numpy(), np.arange(4.0))
    assert man.extra["data"]["step"] == 1


def test_async_failure_surfaces_on_the_next_save(tmp_path):
    ck = Checkpointer(str(tmp_path / "x"))
    os.rmdir(tmp_path / "x")
    (tmp_path / "x").write_text("not a directory")
    ck.save_async(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ck.save(2, {"a": torch.zeros(2)})


def test_list_checkpoints_skips_truncated_and_unfinished(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        ck.save(s, {"a": torch.arange(1000.0)})
    with open(tmp_path / "step_3" / "a.npy", "r+b") as f:
        f.truncate(100)
    os.makedirs(tmp_path / "step_9.tmp")
    assert [os.path.basename(p) for p in list_checkpoints(str(tmp_path))] == ["step_2", "step_1"]


def test_restore_into_meta_targets_and_onto_a_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"params": {"w": torch.randn(3, 4)}, "opt": {"count": torch.tensor(7, dtype=torch.int32)}}
    path = ck.save(3, state)
    got, man = ck.restore(path, {"params": {"w": torch.empty(3, 4, device="meta")}})
    assert man.step == 3 and got["params"]["w"].device.type == "cpu"
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    with pytest.raises(ValueError, match="missing"):
        ck.restore(path, {"params": {"v": torch.zeros(1)}})


def test_save_and_restore_spans_are_traced(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    with Tracer(TraceConfig(out_dir=str(tmp_path / "tr"), mode="default")):
        path = ck.save(2, {"a": torch.zeros(4)})
        ck.save_async(3, {"a": torch.zeros(4)})
        ck.wait()
        ck.restore(path, {"a": torch.zeros(4)})
    from repro.core.plugins.tally import tally_trace

    t = tally_trace(str(tmp_path / "tr"))
    assert t.apis[("ust_repro", "checkpoint_save")].calls == 2
    assert t.apis[("ust_repro", "checkpoint_restore")].calls == 1


# ---------------------------------------------------------------------------
# Damage tolerance and async-commit errors (``test_resilience.py``'s twins)
# ---------------------------------------------------------------------------


def _save_steps(root, steps):
    ck = Checkpointer(str(root), keep=10)
    for s in steps:
        ck.save(s, {"w": torch.arange(8.0)}, extra={"steps_done": s})
    return ck


def _first_leaf(step_dir):
    with open(step_dir / "manifest.json") as f:
        return step_dir / json.load(f)["leaves"][0]["file"]


def test_list_checkpoints_newest_first(tmp_path):
    _save_steps(tmp_path, [2, 10, 6])
    names = [os.path.basename(p) for p in list_checkpoints(str(tmp_path))]
    assert names == ["step_10", "step_6", "step_2"]
    assert latest_checkpoint(str(tmp_path)).endswith("step_10")
    assert list_checkpoints(str(tmp_path / "nowhere")) == []


def test_latest_checkpoint_skips_corrupt_manifest(tmp_path):
    _save_steps(tmp_path, [4, 8])
    with open(tmp_path / "step_8" / "manifest.json", "w") as f:
        f.write("{this is not json")
    assert latest_checkpoint(str(tmp_path)).endswith("step_4")


def test_latest_checkpoint_skips_truncated_leaf(tmp_path):
    _save_steps(tmp_path, [4, 8])
    leaf = _first_leaf(tmp_path / "step_8")
    leaf.write_bytes(leaf.read_bytes()[:10])
    assert latest_checkpoint(str(tmp_path)).endswith("step_4")


def test_latest_checkpoint_skips_missing_leaf(tmp_path):
    _save_steps(tmp_path, [4, 8])
    os.remove(_first_leaf(tmp_path / "step_8"))
    assert latest_checkpoint(str(tmp_path)).endswith("step_4")
    # every checkpoint damaged: None, not an exception
    os.remove(tmp_path / "step_4" / "manifest.json")
    assert latest_checkpoint(str(tmp_path)) is None


def test_restore_still_validates_crc(tmp_path):
    """``list_checkpoints`` checks the structure only: a flipped payload byte
    is caught by ``restore``."""
    ck = _save_steps(tmp_path, [4])
    leaf = _first_leaf(tmp_path / "step_4")
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    path = latest_checkpoint(str(tmp_path))
    assert path.endswith("step_4")
    with pytest.raises(ValueError, match="integrity"):
        ck.restore(path, {"w": torch.zeros(8)})


def _broken_writer(ck, monkeypatch):
    def boom(step, host_leaves, extra):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", boom)


def test_save_async_error_surfaces_from_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    _broken_writer(ck, monkeypatch)
    ck.save_async(1, {"a": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ck.wait()
    ck.wait()  # the error is consumed, not raised again


def test_save_async_error_surfaces_from_next_save_async(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    _broken_writer(ck, monkeypatch)
    ck.save_async(1, {"a": torch.zeros(4)})
    while ck._pending.is_alive():
        time.sleep(0.01)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ck.save_async(2, {"a": torch.zeros(4)})
    # the checkpointer stays usable after surfacing the failure
    assert ck.save(3, {"a": torch.zeros(4)}).endswith("step_3")


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def _jax_state():
    jm = JaxModel(jax_get_config("h2o-danube-1.8b").smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    opt = jax_adamw_init(jp, JaxAdamWConfig())
    opt["count"] = jnp.asarray(3, jnp.int32)
    opt["mu"] = jax.tree_util.tree_map(lambda p: p * 0.5, jp)
    return {"params": jp, "opt": opt}


def _assert_same(port_tree, jax_tree):
    want = list(tree.items(jax.tree_util.tree_map(np.asarray, jax_tree)))
    got = list(tree.items(port_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), key


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    jst = _jax_state()
    path = JaxCheckpointer(str(tmp_path)).save(3, jst, extra={"data": {"step": 3, "seed": 1234, "dp_rank": 0}})
    target = state_from_jax(jax.tree_util.tree_map(np.zeros_like, jax.tree_util.tree_map(np.asarray, jst)), "cpu")
    got, man = Checkpointer(str(tmp_path)).restore(path, target)
    _assert_same(got, jst)
    assert man.step == 3 and man.extra["data"]["step"] == 3


def test_a_port_checkpoint_restores_in_the_jax_package(tmp_path):
    jst = _jax_state()
    st = state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    path = Checkpointer(str(tmp_path)).save(3, st, extra={"data": {"step": 3}})
    with open(os.path.join(path, "manifest.json")) as f:
        jman = json.load(f)
    jgot, man = JaxCheckpointer(str(tmp_path)).restore(path, jax.tree_util.tree_map(jnp.zeros_like, jst))
    _assert_same(st, jgot)
    assert man.step == 3
    assert {leaf["dtype"] for leaf in jman["leaves"]} == {"float32", "int32"}


def test_bf16_round_trip_in_the_port_is_bit_exact(tmp_path):
    w = torch.randn(5, 7).to(torch.bfloat16)
    w[0, :4] = torch.tensor([float("inf"), float("-inf"), -0.0, 1e-40])
    state = {"w": w, "s": torch.tensor(2.5, dtype=torch.bfloat16)}
    path = Checkpointer(str(tmp_path)).save(1, state)
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = {leaf["key"]: leaf for leaf in json.load(f)["leaves"]}
    assert leaves["w"]["dtype"] == "bfloat16" and leaves["w"]["nbytes"] == 70
    assert np.load(os.path.join(path, "w.npy")).dtype == np.uint16
    got, _ = Checkpointer(str(tmp_path)).restore(path, state)
    for k in state:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), state[k].view(torch.int16))


def test_bf16_leaves_across_the_packages(tmp_path):
    """The port reads a JAX-written bf16 leaf bit for bit as bfloat16; the JAX
    checkpointer keeps the bits of either package's bf16 leaf but not its
    dtype: a port leaf comes back as uint16 words, its own as 2-byte voids
    (ROADMAP fault 24)."""
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jpath = JaxCheckpointer(str(tmp_path / "j")).save(1, {"w": jx})
    got, _ = Checkpointer(str(tmp_path / "j")).restore(jpath, {"w": torch.zeros(4, 6, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].view(torch.int16).numpy().tobytes() == np.asarray(jx).tobytes()
    jown, _ = JaxCheckpointer(str(tmp_path / "j")).restore(jpath, {"w": jx})
    assert jown["w"].dtype == np.dtype("V2") and jown["w"].tobytes() == np.asarray(jx).tobytes()
    ppath = Checkpointer(str(tmp_path / "p")).save(1, {"w": got["w"]})
    jgot, _ = JaxCheckpointer(str(tmp_path / "p")).restore(ppath, {"w": jx})
    assert jgot["w"].dtype == np.uint16 and jgot["w"].tobytes() == np.asarray(jx).tobytes()
