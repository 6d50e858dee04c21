"""The port's dry run (``repro_torch.launch.dryrun``) on one device.

* A hand-written kernel's op on meta tensors returns outputs of the
  kernel's shapes and dtypes and is counted as one unit of the FLOPs and
  bytes its trace span carries.
* For the smoke config of each family, the count on meta tensors equals
  the same counter over a real CPU run of the same step, exactly: FLOPs,
  bytes, peak, the inputs' and outputs' bytes and the kernel calls (train
  for the dense, VLM, MoE and audio families; prefill and decode for all).
* The full-depth count equals ``extrapolate`` of the 1- and 2-unit counts
  (dense, MoE and SSM families), exactly; the hybrid family's fractional
  depth units are read against its direct count.
* The products-only FLOPs against XLA's ``cost_analysis()`` of
  ``jax.grad`` over the JAX package's unrolled ``with_depth`` models: XLA
  also counts elementwise operations, so the ratio is at most 1 and at
  least a floor per family (measured on this port: dense 0.960-0.963, VLM
  0.961-0.965, MoE 0.969-0.970, audio 0.896-0.935 at 1, 2 and 4 units; the
  test compiles 1, 2 and 4 units for the dense family, 1 and 2 for the others).
* The CLI: ``--list`` is the JAX dry run's single-mesh cell list, a
  full-width cell writes its JSON, the SSM train cell is refused naming
  ROADMAP section 4, the four configs that set ``remat="dots"`` run.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.config import with_depth as jax_with_depth
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.config import depth_units, with_depth

DANUBE = "h2o-danube-1.8b"
KINDS = {k: ShapeSpec(f"smoke_{k}", k, 16, 2) for k in ("train", "prefill", "decode")}
TRAINED = [DANUBE, "llava-next-34b", "moonshot-v1-16b-a3b", "whisper-medium"]
SERVED = TRAINED + ["mamba2-1.3b", "recurrentgemma-2b"]
CASES = [(a, "train") for a in TRAINED] + [(a, k) for a in SERVED for k in ("prefill", "decode")]


def _counts(c) -> dict:
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak, "arg_bytes": c.arg_bytes,
            "out_bytes": c.out_bytes, "kernels": dict(c.kernels)}


def count(cfg, shape, device="meta"):
    """The counter's readings of ``shape``'s step, after one run that fills
    the process's caches (the CPU RoPE table is made once per device)."""
    m = Model(cfg)
    dryrun.count_step(m, shape, dryrun.step_inputs(m, shape, device), device)
    return _counts(dryrun.count_step(m, shape, dryrun.step_inputs(m, shape, device), device))


# ---------------------------------------------------------------------------
# Kernels on meta tensors
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_on_meta_gives_the_kernels_output_and_its_span_figures(causal):
    B, S, T, H, Kv, d = 2, 48, 64, 8, 2, 80
    q, k, v = _meta(B, S, H, d), _meta(B, T, Kv, d), _meta(B, T, Kv, d)
    with dryrun.Counter("meta") as c:
        o = ops.flash_attention(q, k, v, causal=causal, window=None)
    assert (o.shape, o.dtype, o.device.type, o.is_contiguous()) == (q.shape, q.dtype, "meta", True)
    assert c.flops == 4 * B * H * S * T * d // (2 if causal else 1)
    assert c.bytes == 2 * 2 * (B * S * H * d + 2 * B * T * Kv * d)
    assert dict(c.kernels) == {"flash_attention": 1} and c.peak == 2 * B * S * H * d


def test_ssd_and_rglru_on_meta_give_the_kernels_outputs():
    B, S, H, P, G, N, C = 2, 64, 4, 16, 1, 32, 96
    with dryrun.Counter("meta") as c:
        y, st = ops.ssd(_meta(B, S, H, P), _meta(B, S, H, dtype=torch.float32), _meta(H, dtype=torch.float32),
                        _meta(B, S, G, N), _meta(B, S, G, N), _meta(H, dtype=torch.float32), chunk=16)
        h, h_last = ops.rglru(_meta(B, S, C), _meta(B, S, C), _meta(B, S, C), _meta(C, dtype=torch.float32))
    assert (tuple(y.shape), y.dtype, tuple(st.shape), st.dtype) == ((B, S, H, P), torch.bfloat16, (B, H, P, N),
                                                                    torch.float32)
    assert (tuple(h.shape), h.dtype, tuple(h_last.shape), h_last.dtype) == ((B, S, C), torch.bfloat16, (B, C),
                                                                            torch.float32)
    assert c.flops == B * S * H * (2 * P * N * 3 + 2 * 64 * P) + 6 * B * S * C
    assert dict(c.kernels) == {"ssd_scan": 1, "rglru_scan": 1}


def test_a_device_with_no_kernel_plain_version_or_shape_function_raises():
    t = types.SimpleNamespace(device=torch.device("mps"))
    with pytest.raises(ValueError, match="no kernel, plain version or shape function"):
        ops._call("flash_attention", (1,), 0, 0, t, None, None, None)


def test_a_kernel_call_on_the_cpu_counts_as_one_launch():
    """The plain version's own operators are not counted: the call is the
    span's FLOPs and bytes, as on meta tensors."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 4, 16, generator=g) for _ in range(3))
    with dryrun.Counter("cpu") as c:
        ops.flash_attention(q, k, v)
    qm, km, vm = (t.to("meta") for t in (q, k, v))
    with dryrun.Counter("meta") as m:
        ops.flash_attention(qm, km, vm)
    assert _counts(c) == _counts(m) and c.flops == 4 * 4 * 8 * 8 * 16 // 2


# ---------------------------------------------------------------------------
# Meta against a real CPU run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", CASES)
def test_meta_counts_equal_a_cpu_run_of_the_same_step(arch, kind):
    cfg = get_config(arch).smoke()
    meta, cpu = count(cfg, KINDS[kind], "meta"), count(cfg, KINDS[kind], "cpu")
    assert meta == cpu
    assert meta["flops"] > 0 and meta["bytes"] > 0 and meta["peak"] >= meta["arg_bytes"] + meta["out_bytes"]


def test_kernel_calls_of_the_served_steps():
    assert count(get_config(DANUBE).smoke(), KINDS["prefill"])["kernels"] == {"flash_attention": 4}
    assert count(get_config("mamba2-1.3b").smoke(), KINDS["prefill"])["kernels"] == {"ssd_scan": 4}
    assert count(get_config("recurrentgemma-2b").smoke(), KINDS["prefill"])["kernels"] == {"rglru_scan": 4}
    assert count(get_config("whisper-medium").smoke(), KINDS["prefill"])["kernels"] == {"flash_attention": 10}
    for arch in SERVED:  # decode runs no kernel of the JAX package's in the dense families
        if arch not in ("mamba2-1.3b", "recurrentgemma-2b"):
            assert count(get_config(arch).smoke(), KINDS["decode"])["kernels"] == {}


# ---------------------------------------------------------------------------
# Depth
# ---------------------------------------------------------------------------


def _meas(cfg, shape):
    c = count(cfg, shape)
    return {"flops": float(c["flops"]), "bytes_accessed": float(c["bytes"]), "coll_bytes": 0.0,
            "coll_counts": {}, "coll_by_kind": {}}


@pytest.mark.parametrize("arch,kind", [(DANUBE, "train"), (DANUBE, "prefill"), (DANUBE, "decode"),
                                       ("moonshot-v1-16b-a3b", "train"), ("moonshot-v1-16b-a3b", "prefill"),
                                       ("mamba2-1.3b", "prefill"), ("mamba2-1.3b", "decode")])
def test_full_depth_count_equals_the_extrapolation_of_one_and_two_units(arch, kind):
    cfg = get_config(arch).smoke()
    assert depth_units(cfg) == 4
    shape = KINDS[kind]
    want = rl.extrapolate(_meas(with_depth(cfg, 1), shape), _meas(with_depth(cfg, 2), shape), depth_units(cfg))
    assert want == _meas(cfg, shape)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_hybrid_fractional_depth_units_read_against_the_direct_count(kind):
    """recurrentgemma-2b's 26 layers are 8 groups of (rec, rec, attn) and a
    tail of two recurrent blocks: ``depth_units`` says 26/3 = 8.67 groups.
    The direct count is 8 groups and two recurrent blocks exactly;
    ``extrapolate`` at 8.67 units reads the tail as 2/3 of a group, so it
    is off by 2/3 of a group less two recurrent blocks (2/3 of an
    attention block less 2/3 of a recurrent one)."""
    base = dataclasses.replace(get_config("recurrentgemma-2b").smoke(), num_layers=26)
    shape = KINDS[kind]
    m = {n: _meas(dataclasses.replace(base, num_layers=n), shape) for n in (3, 4, 6, 26)}
    for key in ("flops", "bytes_accessed"):
        group, rec = m[6][key] - m[3][key], m[4][key] - m[3][key]
        assert m[26][key] == m[3][key] + 7 * group + 2 * rec
        units = depth_units(base)
        assert units == pytest.approx(26 / 3)
        got = rl.extrapolate(m[3], m[6], units)[key]
        assert got == pytest.approx(m[26][key] + (2 / 3) * group - 2 * rec, rel=1e-12)
        assert got != m[26][key]


# ---------------------------------------------------------------------------
# Against XLA
# ---------------------------------------------------------------------------

#: (lowest, highest) products-only FLOPs over XLA's FLOPs, by family
XLA_RATIO = {DANUBE: (0.90, 1.00), "llava-next-34b": (0.90, 1.00), "moonshot-v1-16b-a3b": (0.95, 1.00),
             "whisper-medium": (0.85, 1.00)}


def _xla_flops(arch, units, B, S):
    cfg = jax_with_depth(jax_get_config(arch).smoke(), units)
    jm = JaxModel(cfg)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    n = S - cfg.vision_tokens
    batch = {"tokens": jax.ShapeDtypeStruct((B, n), jnp.int32), "labels": jax.ShapeDtypeStruct((B, n), jnp.int32)}
    if cfg.vision_tokens:
        batch["patch_embeds"] = jax.ShapeDtypeStruct((B, cfg.vision_tokens, cfg.d_model), jnp.float32)
    if cfg.family == "audio":
        batch["frames"] = jax.ShapeDtypeStruct((B, cfg.encdec.enc_positions, cfg.d_model), jnp.float32)
    cost = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0])).lower(params, batch).compile().cost_analysis()
    return float((cost[0] if isinstance(cost, list) else cost)["flops"])


@pytest.mark.parametrize("arch", TRAINED)
def test_products_only_flops_against_xla_cost_analysis(arch):
    lo, hi = XLA_RATIO[arch]
    shape = ShapeSpec("t", "train", 64, 4)
    for units in (1, 2, 4) if arch == DANUBE else (1, 2):
        ours = count(with_depth(get_config(arch).smoke(), units), shape)["flops"]
        ratio = ours / _xla_flops(arch, units, 4, 64)
        assert lo <= ratio <= hi, (units, ratio)


def test_dense_smoke_train_products_are_the_measured_counts():
    """h2o-danube-1.8b smoke, 4 x 64 tokens: each layer adds the same
    products, so the count is linear in depth."""
    shape = ShapeSpec("t", "train", 64, 4)
    got = [count(with_depth(get_config(DANUBE).smoke(), u), shape)["flops"] for u in (1, 2, 4)]
    assert got == [94_371_840, 163_577_856, 301_989_888]


# ---------------------------------------------------------------------------
# remat and the peak
# ---------------------------------------------------------------------------


def test_dry_run_peak_orders_none_above_dots_above_full():
    shape = ShapeSpec("t", "train", 128, 4)
    peak = {r: count(dataclasses.replace(get_config(DANUBE).smoke(), remat=r), shape)["peak"]
            for r in ("none", "dots", "full")}
    assert peak["none"] > peak["dots"] > peak["full"], peak


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mistral-large-123b", "llava-next-34b", "kimi-k2-1t-a32b"])
def test_the_configs_that_set_remat_dots_dry_run(arch):
    """Two of their layers at full width, train_4k: the step builds."""
    cfg = get_config(arch)
    assert cfg.remat == "dots"
    res = dryrun.run_cell(arch, "train_4k", cfg=with_depth(cfg, 2))
    assert res["ok"] and res["roofline"]["flops"] > 0 and res["fits"] is False


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_list_equals_the_jax_dry_runs_single_mesh_cells(capsys):
    """The JAX module sets XLA_FLAGS when imported (its 512 host devices);
    the environment is put back at once, before any JAX backend starts."""
    env = dict(os.environ)
    try:
        from repro.launch.dryrun import cells as jax_cells
    finally:
        os.environ.clear()
        os.environ.update(env)
    assert dryrun.main(["--list"]) == 0
    got = [tuple(line.split()) for line in capsys.readouterr().out.splitlines()]
    assert got == [(arch, shape) for arch, shape, _ in jax_cells("all", "all", "single")]
    assert dryrun.cells("all", "all") == got
    assert {a for a, _ in got} == set(ARCHS)


def test_one_full_width_cell_writes_its_json(tmp_path, capsys):
    assert dryrun.main(["--arch", DANUBE, "--shape", "train_4k", "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "h2o-danube-1.8b        train_4k" in out and "1/1 cells ran" in out
    with open(tmp_path / f"{DANUBE}__train_4k__1device.json") as f:
        res = json.load(f)
    assert res["arch"] == DANUBE and res["shape"] == "train_4k" and res["ok"]
    assert res["mesh"] == "1 device" and res["n_devices"] == 1 and res["t_dryrun_s"] > 0
    rf = res["roofline"]
    assert rf["device_kind"] == rl.H100.name and rf["coll_bytes"] == 0.0
    cfg = get_config(DANUBE)
    assert rf["model_flops"] == 6 * cfg.active_params() * 256 * 4096
    assert rf["peak_bytes"] > rl.H100.memory_bytes and res["fits"] is False
    assert res["memory_bytes"] == rl.H100.memory_bytes
    # --skip-existing leaves the cell alone
    assert dryrun.main(["--arch", DANUBE, "--shape", "train_4k", "-o", str(tmp_path), "--skip-existing"]) == 0
    assert "0/0 cells ran" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_the_train_cells_of_the_ssm_and_hybrid_families_are_refused(arch, tmp_path, capsys):
    assert dryrun.main(["--arch", arch, "--shape", "train_4k", "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "REFUSED" in out and "ROADMAP section 4" in out and "1 refused" in out
    with open(tmp_path / f"{arch}__train_4k__1device.json") as f:
        res = json.load(f)
    assert res["ok"] is False and "ROADMAP section 4" in res["refused"]


def test_an_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no published figures"):
        dryrun.main(["--arch", DANUBE, "--shape", "decode_32k", "--device-kind", "TPU v5e"])
