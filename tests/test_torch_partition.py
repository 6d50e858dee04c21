"""PyTorch port, the mesh and the partitioner against the JAX package.

``logical_to_pspec`` and ``Partitioner.pspec`` map every leaf of every
arch's full parameter tree, and of its decode cache, onto the 16×16 and
2×16×16 production meshes in the ``tp``, ``fsdp`` and ``serve2d`` modes;
JAX's ``logical_to_pspec`` reads only ``mesh.shape``, so a stand-in with a
``shape`` dict serves it and JAX needs no devices.  The specs must be
equal entry for entry.  Also: the partitioner's sizes, the error cases,
``describe``, and the meshes' refusals (a logical mesh has no group, an
indivisible world raises, a "model" axis over 1 with no process group
raises in ``moe_ffn``).
"""

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jax_mesh
from repro.models import Model as JaxModel
from repro.models import ShapeSpec as JaxShapeSpec
from repro.models.param import Spec as JaxSpec
from repro.sharding import Partitioner as JaxPartitioner
from repro.sharding import logical_to_pspec as jax_logical_to_pspec
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import Mesh, describe, make_local_mesh, make_production_mesh
from repro_torch.models import Model, ShapeSpec, moe
from repro_torch.models.param import Spec
from repro_torch.sharding import Partitioner, PartitionSpec, logical_to_pspec
from repro_torch.sharding.placement import block_shape

MODES = ("tp", "fsdp", "serve2d")
DECODE = (ShapeSpec("d", "decode", 4096, 32), JaxShapeSpec("d", "decode", 4096, 32))


class StandIn:
    """A mesh as ``logical_to_pspec`` reads it: axis sizes by name."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)


def leaves(tree, cls, prefix=""):
    if isinstance(tree, cls):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], cls, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from leaves(v, cls, f"{prefix}/{i}")


def trees(arch: str, which: str):
    if which == "params":
        return Model(get_config(arch)).param_specs(), JaxModel(jax_get_config(arch)).param_specs()
    return Model(get_config(arch)).cache_specs(DECODE[0]), JaxModel(jax_get_config(arch)).cache_specs(DECODE[1])


@pytest.mark.parametrize("which", ("params", "cache"))
@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_maps_as_jax_maps_it(arch, multi_pod, which):
    mesh = make_production_mesh(multi_pod=multi_pod)
    stand_in = StandIn(mesh.shape)
    ours, theirs = trees(arch, which)
    ours, theirs = dict(leaves(ours, Spec)), dict(leaves(theirs, JaxSpec))
    assert ours.keys() == theirs.keys() and ours
    for mode in MODES:
        part, jpart = Partitioner(mesh, mode=mode), JaxPartitioner(stand_in, mode=mode)
        for key, s in ours.items():
            want = jpart.pspec(theirs[key].axes, theirs[key].shape)
            got = part.pspec(s.axes, s.shape)
            assert isinstance(got, PartitionSpec)
            assert tuple(got) == tuple(want), (mode, key)
            assert tuple(logical_to_pspec(s.axes, s.shape, mesh, part.rules)) == tuple(
                jax_logical_to_pspec(s.axes, s.shape, stand_in, jpart.rules))
            shard = block_shape(s.shape, got, mesh)
            assert all(dim * n == full for dim, n, full in zip(
                shard, [_ranks(mesh, got, i) for i in range(len(s.shape))], s.shape))


def _ranks(mesh, spec, dim):
    n = 1
    for a in spec.axes_of(dim):
        n *= mesh.shape[a]
    return n


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("mode", MODES)
def test_partitioner_sizes_and_rules_are_jax(mode, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    part, jpart = Partitioner(mesh, mode=mode), JaxPartitioner(StandIn(mesh.shape), mode=mode)
    assert part.rules == jpart.rules
    assert (part.mode, part.fsdp) == (jpart.mode, jpart.fsdp)
    assert part.data_axes() == jpart.data_axes()
    assert part.model_axis_size() == jpart.model_axis_size()
    assert part.dp_size() == jpart.dp_size()
    assert Partitioner(mesh, fsdp=True).mode == JaxPartitioner(StandIn(mesh.shape), fsdp=True).mode == "fsdp"


def test_tree_pspecs_is_pspec_per_leaf():
    model = Model(get_config("moonshot-v1-16b-a3b"))
    part = Partitioner(make_production_mesh(), mode="serve2d")
    specs = part.tree_pspecs(model.shapes(), model.axes())
    assert specs["blocks"]["w_gate"] == PartitionSpec(None, "model", None, "data")
    assert specs["embed"]["tok"] == PartitionSpec("model")
    for key, s in leaves(model.param_specs(), Spec):
        node = specs
        for k in key[1:].split("/"):
            node = node[k]
        assert node == part.pspec(s.axes, s.shape)


@pytest.mark.parametrize("axes,shape,err", [
    (("embed",), (4, 4), ValueError),  # rank mismatch
    (("embed", "nonesuch"), (4, 4), KeyError),  # no rule
])
def test_errors_are_jax_errors(axes, shape, err):
    mesh = make_production_mesh()
    with pytest.raises(err):
        logical_to_pspec(axes, shape, mesh)
    with pytest.raises(err):
        jax_logical_to_pspec(axes, shape, StandIn(mesh.shape))


def test_describe_is_jax_describe():
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert describe(mesh) == jax_mesh.describe(StandIn(mesh.shape))
    assert describe(Mesh({"data": 2, "model": 2})) == "data=2xmodel=2"
    assert describe(make_local_mesh()) == "data=1xmodel=1"


def test_meshes_refuse_what_they_cannot_do():
    prod = make_production_mesh()
    with pytest.raises(RuntimeError, match="logical"):
        prod.group("model")
    with pytest.raises(RuntimeError, match="logical"):
        prod.index("data")
    with pytest.raises(RuntimeError):
        Partitioner(prod).placements(PartitionSpec("model"))
    with pytest.raises(ValueError, match="not divisible"):
        make_local_mesh(model_parallel=3)  # one rank: no process group is up
    one = make_local_mesh()
    assert one.index("model") == 0 and one.size == 1 and one.device_mesh is None


def test_a_model_axis_without_a_process_group_raises():
    """Never the dense path in disguise: a "model" axis over 1 on a mesh
    with no process group behind it raises."""
    cfg = get_config("moonshot-v1-16b-a3b").smoke()
    p = Model(cfg).init(torch.Generator().manual_seed(0))["blocks"]
    pl = {k: p[k][0] for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.zeros(2, 4, cfg.d_model)
    with pytest.raises(RuntimeError, match="process group"):
        moe.moe_ffn(cfg, pl, x, make_production_mesh())
    y, _ = moe.moe_ffn(cfg, pl, x, make_local_mesh())  # one rank: the dense path
    assert torch.equal(y, moe.moe_ffn(cfg, pl, x)[0])
