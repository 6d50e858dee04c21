"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's ``repro.launch.roofline``.

``model_flops_for`` and ``extrapolate`` are carried over unchanged, so they
equal the JAX functions exactly on the same inputs; the ``Roofline`` terms
follow the JAX formulas with the card's published figures in place of the
TPU's.  ``measure``, ``memory_stats`` and ``analyze`` read the dry run's
counter (``repro_torch.launch.dryrun.Counter``) where the JAX ones read a
compiled XLA module.
"""

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jrl
from repro.models import applicable_shapes as jax_applicable_shapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import Counter
from repro_torch.models.config import applicable_shapes


def test_archs_and_shapes_are_the_jax_packages():
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        assert [s.name for s in applicable_shapes(get_config(arch))] == [
            s.name for s in jax_applicable_shapes(jax_get_config(arch))
        ]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_devices", [1, 256])
def test_model_flops_for_equals_jax(arch, n_devices):
    for shape, jshape in zip(applicable_shapes(get_config(arch)), jax_applicable_shapes(jax_get_config(arch)),
                             strict=True):
        got = rl.model_flops_for(get_config(arch), shape, n_devices)
        want = jrl.model_flops_for(jax_get_config(arch), jshape, n_devices)
        assert got == want, (arch, shape.name)


def _meas(rng, kinds=("all-reduce", "all-gather")):
    return {
        "flops": float(rng.integers(1, 10**15)),
        "bytes_accessed": float(rng.integers(1, 10**13)),
        "coll_bytes": float(rng.integers(0, 10**10)),
        "coll_counts": {k: int(rng.integers(0, 50)) for k in kinds},
        "coll_by_kind": {k: int(rng.integers(0, 10**9)) for k in kinds},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("units", [1.0, 2.0, 24.0, 26 / 3, 61.0])
def test_extrapolate_equals_jax(seed, units):
    rng = np.random.default_rng(seed)
    m1, m2 = _meas(rng), _meas(rng, kinds=("all-reduce", "reduce-scatter"))
    assert rl.extrapolate(m1, m2, units) == jrl.extrapolate(m1, m2, units)


def test_h100_row_is_the_published_figures():
    h = rl.card("NVIDIA H100 80GB HBM3")
    assert h is rl.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.memory_bytes) == (989.4e12, 3.35e12, 450e9, 80 * 2**30)


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "TPU v5e", ""])
def test_an_unknown_card_raises(kind):
    with pytest.raises(KeyError, match="no published figures"):
        rl.card(kind)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_roofline_terms_follow_the_jax_formulas_with_the_h100_figures(seed):
    rng = np.random.default_rng(seed)
    meas = _meas(rng)
    model_flops = float(rng.integers(1, 10**15))
    mem = {"arg_bytes": 5, "out_bytes": 6, "temp_bytes": 7, "peak_bytes": 18}
    got = rl.roofline_from(meas, model_flops, mem)
    want = jrl.roofline_from(meas, model_flops, mem)
    h = rl.H100
    assert got.t_compute == pytest.approx(want.t_compute * jrl.PEAK_FLOPS / h.peak_flops, rel=1e-12)
    assert got.t_memory == pytest.approx(want.t_memory * jrl.HBM_BW / h.hbm_bw, rel=1e-12)
    assert got.t_collective == pytest.approx(want.t_collective * jrl.ICI_BW / h.link_bw, rel=1e-12)
    terms = {"compute": got.t_compute, "memory": got.t_memory, "collective": got.t_collective}
    assert got.bottleneck == max(terms, key=terms.get)
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.roofline_fraction == pytest.approx(
        (model_flops / h.peak_flops) / max(terms.values()), rel=1e-12)
    js, jjs = got.to_json(), want.to_json()
    assert set(jjs) | {"device_kind"} == set(js)
    assert js["device_kind"] == h.name
    for k in ("flops", "bytes_accessed", "coll_bytes", "coll_counts", "coll_by_kind", "model_flops",
              "useful_flops_ratio", "arg_bytes", "out_bytes", "temp_bytes", "peak_bytes"):
        assert js[k] == jjs[k], k


def test_roofline_of_an_idle_step_is_zero():
    rf = rl.roofline_from({"flops": 0.0, "bytes_accessed": 0.0, "coll_bytes": 0.0, "coll_counts": {},
                           "coll_by_kind": {}}, 0.0, {})
    assert rf.useful_flops_ratio == 0.0 and rf.roofline_fraction == 0.0


def test_measure_memory_stats_and_analyze_read_the_counter():
    """A product of [64, 32] by [32, 16] on meta tensors: 2·64·32·16 FLOPs,
    its inputs and output read and written once, the peak with its inputs."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    with Counter("meta") as c:
        c.arg_bytes = c.track(a, b)
        out = a @ b
        c.out_bytes = c.track(out)
    assert rl.measure(c) == {"flops": 2.0 * 64 * 32 * 16, "bytes_accessed": 4.0 * (64 * 32 + 32 * 16 + 64 * 16),
                             "coll_bytes": 0.0, "coll_counts": {}, "coll_by_kind": {}}
    # the output was seen when the product made it
    assert rl.memory_stats(c) == {"arg_bytes": 4 * (64 * 32 + 32 * 16), "out_bytes": 0,
                                  "temp_bytes": 4 * 64 * 16, "peak_bytes": 4 * (64 * 32 + 32 * 16 + 64 * 16)}
    cfg = get_config("h2o-danube-1.8b")
    from repro_torch.models import SHAPES

    rf = rl.analyze(c, cfg, SHAPES["decode_32k"])
    assert rf.flops == 2.0 * 64 * 32 * 16 and rf.coll_bytes == 0.0 and rf.t_collective == 0.0
    assert rf.model_flops == 2 * cfg.active_params() * 128
    assert rf.card is rl.H100
