#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each fatal on failure:
  1. build every CUDA source under src/repro_torch/csrc/ (one nvcc each,
     all started together) and print the build time and the compiler's
     register and spill report;
  2. Mamba2-1.3B: hold the SSD scan kernel against its plain PyTorch
     version at H=64, P=64, G=1, N=128 (one and four chunks, a ragged
     100-step chunk, a non-zero state0; fp32 within 1e-4, bf16 within
     2e-2) and time both; hold a two-layer full-width model's prefill +
     decode on the card (kernel path) against the CPU (plain path) in fp32;
     serve the full-width model (48 layers, bf16, random weights from a
     seed) under a default-mode THAPI trace: 4 slots, prompts of 100, 256,
     512 and 1024 tokens, 16 new tokens each; tally the trace with the
     port's own tally and check that every prefill went through the kernel;
     then the tracing-overhead turns;
  3. RecurrentGemma-2B: hold the RG-LRU scan kernel against its plain
     version at C=2560 for (B, S) in (1,1), (4,1), (1,100), (1,1024),
     (1,3000), with h0 absent, fp32 and bf16, and at S=1024 and 3000 with
     the decays of the model's init (0.9 to 0.999), where h carries far
     (fp32 within 2e-5, bf16 within 2e-2); time both; hold a five-layer full-width model (one group and
     a two-block tail) on the card against the CPU in fp32; serve the
     full-width model (26 layers, bf16) the same way: cache_len 2048,
     prompts of 100, 512, 1024, 2040 (its ring wraps while decoding), 3000
     (longer than the window, so the prefill ring is rolled) and 512
     tokens; check that every prefill and every decode step went through
     the RG-LRU kernel in each of the 18 recurrent blocks; profile a warm
     decode step and prefill.  Each serving run resets the launch counts
     just before it and reads them just after;
  4. the full-mode polling fence, and the command-line launcher at full
     width under a trace, for both models.
Prints the card's name and power limit first, a ``{"kernels": [...]}`` line
before the last, and ``{"ok": true, "device": {...}}`` last.  Exits non-zero,
printing no result, without a CUDA card or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: published H100 SXM peaks (NVIDIA data sheet), for the bound column
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

DEVICE = "cuda"
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RGLRU_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PROMPT_LENS = (100, 256, 512, 1024, 100, 512)
RG_PROMPT_LENS = (100, 512, 1024, 2040, 3000, 512)
NEW_TOKENS = 16
#: fp32 operations per element of the RG-LRU (4 exp, 2 divisions, a sqrt
#: and ~13 adds, multiplies, maxima and FMAs), for its bound
RGLRU_OPS_PER_ELEMENT = 20


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _numel(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def host_vs_device(fn, reps: int = 5) -> tuple:
    """(host ms to return from ``fn()``, ms until the card has finished it),
    medians over ``reps`` warm runs."""
    import torch

    fn()
    host, done = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    return sorted(host)[reps // 2], sorted(done)[reps // 2]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card, CUDA events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_device_ms(fn, kernel: str, reps: int = 20):
    """Device time per call of the CUDA kernels whose name holds ``kernel``,
    from a torch.profiler trace of ``reps`` warm calls: the kernel's own run,
    without the host time of its wrapper that CUDA events around one call
    include when the host is slower than the card.  Raises if the profiler
    records no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not us:
        raise AssertionError(f"the profiler recorded no device kernel named like {kernel!r}")
    return sum(us) / reps / 1e3


def profile_step(fn, label: str, tag: str) -> None:
    """One warm call of ``fn`` under torch.profiler: wall time to completion,
    the card's busy time (the kernels' and copies' device intervals; one
    stream, so they do not overlap), its idle share, and the kernels that
    take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[{tag}] profile {label}: wall {wall:.2f} ms; the profiler recorded no device time (not measured)")
        return
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[{tag}] profile {label}: wall {wall:.2f} ms under the profiler, device busy {busy:.2f} ms "
          f"({len(dev)} device ops), idle share {1 - busy / wall:.3f}")
    for name, ms in top:
        print(f"[{tag}]   {ms:8.3f} ms  {name[:110]}")


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    from repro_torch.kernels import _build

    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        paths = list(pool.map(_build.build, names))
    for name, path in zip(names, paths):
        print(f"[build] {name} -> {os.path.relpath(path, ROOT)}")
    print(f"[build] {len(names)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[ptxas] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------


def ssd_inputs(S: int, dtype, with_state0: bool, seed: int):
    import torch

    H, P, G, N = 64, 64, 1, 128
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    x = torch.randn(1, S, H, P, generator=g, device=dev).to(dtype)
    dt = torch.empty(1, S, H, device=dev).uniform_(1e-3, 0.1, generator=g)
    A_log = torch.empty(H, device=dev).uniform_(0.0, 2.0, generator=g)
    Bm = torch.randn(1, S, G, N, generator=g, device=dev).to(dtype)
    Cm = torch.randn(1, S, G, N, generator=g, device=dev).to(dtype)
    D = torch.randn(H, generator=g, device=dev)
    state0 = torch.randn(1, H, P, N, generator=g, device=dev) if with_state0 else None
    return x, dt, A_log, Bm, Cm, D, state0


def ssd_bound(S: int, chunk: int, x, Bm, state0) -> tuple:
    """Least time for one call: bytes each read or written once over HBM, and
    the operations the function needs over the bf16 tensor-core peak (fp32:
    the CUDA-core peak).  Per chunk and head the intra-chunk terms C.B^T and
    W.x need only the causal triangle, L(L+1)/2 entries; the inter-chunk
    term C.state and the state update B^T.x are L*P*N each.  Returns
    (ms, bound_by)."""
    B, _, H, P = x.shape
    N = Bm.shape[-1]
    el = x.element_size()
    nbytes = (
        2 * x.numel() * el  # x in, y out
        + 2 * Bm.numel() * el  # Bm, Cm
        + B * S * H * 4  # dt
        + 2 * H * 4  # A_log, D
        + B * H * P * N * 4 * (2 if state0 is not None else 1)  # state0 in, state out
    )
    L, nc = chunk, S // chunk
    tri = L * (L + 1) // 2
    flops = B * H * nc * (2 * tri * N + 2 * tri * P + 2 * 2 * L * P * N)
    peak = BF16_FLOPS_PER_S if el == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_ssd() -> dict:
    import torch

    from repro_torch.kernels import ref, ssd_scan

    cases = [  # (S, chunk, state0)
        (256, 256, False),
        (1024, 256, False),
        (100, 100, False),
        (1024, 256, True),
    ]
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = SSD_TOL[str(dtype).split(".")[1]]
        for i, (S, chunk, st0) in enumerate(cases):
            x, dt, A_log, Bm, Cm, D, state0 = ssd_inputs(S, dtype, st0, seed=i)
            y, st = ssd_scan.ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)
            torch.cuda.synchronize()
            y_ref, st_ref = ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk, state0=state0)
            torch.cuda.synchronize()
            err_y = (y.float() - y_ref.float()).abs().max().item()
            err_s = (st - st_ref).abs().max().item()
            ok = torch.allclose(y.float(), y_ref.float(), rtol=tol, atol=tol) and torch.allclose(
                st, st_ref, rtol=tol, atol=tol
            )
            print(
                f"[ssd] {dtype} S={S} chunk={chunk} state0={st0}: max|dy|={err_y:.3g} "
                f"max|dstate|={err_s:.3g} tol={tol} {'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with ssd_ref at S={S} {dtype}")
            max_err = max(max_err, err_y, err_s)

    # times at the serving path's shapes: one layer's prefill, bf16, batch 1
    rows = []
    for S in (100, 256, 512, 1024):
        chunk = min(256, S)
        x, dt, A_log, Bm, Cm, D, _ = ssd_inputs(S, torch.bfloat16, False, seed=7)
        call = lambda: ssd_scan.ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk)  # noqa: E731
        ms = cuda_ms(call)
        dev = kernel_device_ms(call, "ssd_scan_kernel")
        plain = cuda_ms(lambda: ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk))
        bound, by = ssd_bound(S, chunk, x, Bm, None)
        rows.append((S, ms, dev, plain, bound, by))
        print(
            f"[ssd-time] bf16 B=1 S={S} chunk={chunk}: kernel {ms:.4f} ms per call (CUDA events), "
            f"{dev:.4f} ms on the device (profiler), "
            f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by})"
        )
    # ms and plain_ms: medians of CUDA events around one call; device_ms:
    # the kernel's own time in a profiler trace
    S, ms, dev, plain, bound, by = rows[-1]
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:58",
        "launches": None,  # filled from the serving run
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes the SSD scan
    }


def rglru_inputs(B: int, S: int, dtype, h0_dtype, seed: int, C: int = 2560, long_memory: bool = False):
    """``long_memory`` draws Λ as the models' ``lru_a`` init does (per-step
    decay in [0.9, 0.999]); otherwise Λ ~ N(0, 1) (decay near 0.06)."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x, r, i = (torch.randn(B, S, C, generator=g, device=DEVICE).to(dtype) for _ in range(3))
    if long_memory:
        u = torch.rand(C, generator=g, device=DEVICE) * (0.999 - 0.9) + 0.9
        lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    else:
        lam = torch.randn(C, generator=g, device=DEVICE)
    h0 = None if h0_dtype is None else torch.randn(B, C, generator=g, device=DEVICE).to(h0_dtype)
    return x, r, i, lam, h0


def rglru_bound(x, h0) -> tuple:
    """Least time for one call: x, r, i read and y written once, lam, h0 and
    h_last once, over HBM; RGLRU_OPS_PER_ELEMENT fp32 operations per element
    over the fp32 CUDA-core peak (none of it is a matrix product).  Returns
    (ms, bound_by)."""
    B, S, C = x.shape
    nbytes = 4 * x.numel() * x.element_size() + C * 4 + B * C * 4 * (2 if h0 is not None else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = RGLRU_OPS_PER_ELEMENT * x.numel() / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_rglru() -> dict:
    import torch

    from repro_torch.kernels import ref, rglru_scan

    shapes = [(1, 1), (4, 1), (1, 100), (1, 1024), (1, 3000)]
    # (B, S, h0 dtype, long memory): every shape with Λ ~ N(0, 1), then the
    # long prompts with the decays of the model's init, where h carries far
    cases = [(B, S, h0, False) for B, S in shapes for h0 in (None, torch.float32, torch.bfloat16)]
    cases += [(1, S, h0, True) for S in (1024, 3000) for h0 in (None, torch.float32)]
    max_err = 0.0
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = RGLRU_TOL[str(dtype).split(".")[1]]
        for B, S, h0_dtype, long_memory in cases:
            seed += 1
            x, r, i, lam, h0 = rglru_inputs(B, S, dtype, h0_dtype, seed, long_memory=long_memory)
            y, h = rglru_scan.rglru_scan(x, r, i, lam, h0=h0)
            torch.cuda.synchronize()
            y_ref, h_ref = ref.rglru_ref(x, r, i, lam, h0=h0)
            torch.cuda.synchronize()
            err_y = (y.float() - y_ref.float()).abs().max().item()
            err_h = (h - h_ref).abs().max().item()
            ok = (
                y.dtype == dtype and h.dtype == torch.float32
                and torch.allclose(y.float(), y_ref.float(), rtol=tol, atol=tol)
                and torch.allclose(h, h_ref, rtol=tol, atol=tol)
            )
            print(
                f"[rglru] {dtype} B={B} S={S} C=2560 h0={h0_dtype} "
                f"lam={'lru_a init' if long_memory else 'N(0,1)'}: max|dy|={err_y:.3g} "
                f"max|dh|={err_h:.3g} tol={tol} {'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"rglru_scan disagrees with rglru_ref at B={B} S={S} {dtype}")
            max_err = max(max_err, err_y, err_h)

    # times at the serving path's shapes, bf16: prefill (no h0) and decode
    # (an fp32 h0, as the cache holds after the first step)
    rows = {}
    for B, S in shapes:
        x, r, i, lam, h0 = rglru_inputs(B, S, torch.bfloat16, torch.float32 if S == 1 else None, 99)
        call = lambda: rglru_scan.rglru_scan(x, r, i, lam, h0=h0)  # noqa: E731
        ms = cuda_ms(call)
        dev = kernel_device_ms(call, "rglru_scan_kernel")
        plain = cuda_ms(lambda: ref.rglru_ref(x, r, i, lam, h0=h0))
        bound, by = rglru_bound(x, h0)
        rows[(B, S)] = (ms, dev, plain, bound, by)
        print(
            f"[rglru-time] bf16 B={B} S={S} C=2560: kernel {ms:.4f} ms per call (CUDA events), "
            f"{dev:.4f} ms on the device (profiler), "
            f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by})"
        )
    # ms and plain_ms: medians of CUDA events around one call; device_ms:
    # the kernel's own time in a profiler trace
    ms, dev, plain, bound, by = rows[(1, 1024)]
    return {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:49",
        "launches": None,  # filled from the serving run
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes the RG-LRU scan
    }


# ---------------------------------------------------------------------------
# Reduced-depth full-width models on the card against the CPU
# ---------------------------------------------------------------------------


def check_model_against_cpu() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(1))
    params_cpu = _to(params, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 512))
    out = {}
    for dev, p in ((DEVICE, params), ("cpu", params_cpu)):
        logits, cache = model.prefill(p, {"tokens": torch.as_tensor(toks, device=dev)}, 512)
        steps = [logits]
        tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        for _ in range(2):
            logits, cache = model.decode_step(p, cache, {"token": tok})
            steps.append(logits)
            tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        out[dev] = [t.float().cpu() for t in steps] + [cache["state"].float().cpu()]
    for name, a, b in zip(("prefill", "decode1", "decode2", "state"), out[DEVICE], out["cpu"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} on the card")
        err = (a - b).abs().max().item()
        ok = torch.allclose(a, b, rtol=1e-3, atol=1e-3)
        print(f"[model] 2-layer full-width fp32, 512-token prompt, {name}: card vs cpu max|d|={err:.3g} (tol 1e-3) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"card and CPU disagree on {name}")


def check_hybrid_against_cpu() -> None:
    """Five full-width RecurrentGemma-2B layers (one (rec, rec, attn) group
    and a two-block tail), fp32: a 300-token prompt with cache_len 256 (the
    ring is rolled) and two decode steps, card (kernel) against CPU (plain)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=5, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(2))
    params_cpu = _to(params, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, 300))
    out = {}
    for dev, p in ((DEVICE, params), ("cpu", params_cpu)):
        logits, cache = model.prefill(p, {"tokens": torch.as_tensor(toks, device=dev)}, 256)
        steps = [logits]
        tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        for _ in range(2):
            logits, cache = model.decode_step(p, cache, {"token": tok})
            steps.append(logits)
            tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        out[dev] = [t.float().cpu() for t in steps] + [t.float().cpu() for t in _leaves(cache)]
    names = ["prefill", "decode1", "decode2"] + [f"cache leaf {j}" for j in range(len(out["cpu"]) - 3)]
    worst = 0.0
    for name, a, b in zip(names, out[DEVICE], out["cpu"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} on the card")
        worst = max(worst, (a - b).abs().max().item())
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"card and CPU disagree on {name}: max|d|={(a - b).abs().max().item():.3g}")
    print(f"[model-rg] 5-layer full-width fp32, 300-token prompt, cache_len 256: logits of prefill and "
          f"2 decode steps and {len(names) - 3} cache leaves, card vs cpu max|d|={worst:.3g} (tol 1e-3) ok")


# ---------------------------------------------------------------------------
# Full-width traced serving
# ---------------------------------------------------------------------------


def traced_session(model, params, prompt_lens, rng, tag: str):
    """Serve one request per prompt length (4 slots, cache_len 2048,
    NEW_TOKENS each) under a default-mode trace.  The kernels' launch counts
    are set to 0 just before the run and read just after it.  Checks what
    every serving run must show; returns (engine, tally, launches, decode
    steps)."""
    import torch

    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import render, tally_trace
    from repro_torch.kernels import rglru_scan, ssd_scan
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = model.cfg
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=2048, max_new_tokens=NEW_TOKENS))
    for S in prompt_lens:
        eng.submit(rng.integers(0, cfg.vocab_size, size=(S,)))
    trace_dir = tempfile.mkdtemp(prefix="thapi_smoke_")
    try:
        torch.cuda.reset_peak_memory_stats()
        ssd_scan.launches = rglru_scan.launches = 0
        with Tracer(TraceConfig(out_dir=trace_dir, mode="default")):
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"ssd_scan": ssd_scan.launches, "rglru_scan": rglru_scan.launches}
        peak = torch.cuda.max_memory_allocated()
        tally = tally_trace(trace_dir)
        print(render(tally, top=12))
        print(render(tally, top=12, device=True))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    n = len(prompt_lens)
    if len(done) != n or any(len(r.out_tokens) != NEW_TOKENS for r in done):
        raise AssertionError("not every request got its tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError("token outside the vocabulary")
    prefill = tally.apis.get(("ust_repro", "prefill"))
    decode = tally.apis.get(("ust_repro", "decode_step"))
    if prefill is None or prefill.calls != n:
        raise AssertionError(f"ust_repro:prefill rows {prefill} != {n} requests")
    if decode is None or decode.calls == 0:
        raise AssertionError("no ust_repro:decode_step rows")
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"[{tag}] {n} requests, {tokens} tokens in {wall:.3f} s: {tokens / wall:.2f} tokens/s; "
          f"{decode.calls} decode steps; peak device memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}")
    for (prov, name), st in sorted(tally.device_apis.items()):
        if name.startswith("prefill[") or name.startswith("decode_step["):
            print(f"[{tag}] traced {name}: {st.calls} call(s), avg {st.avg_ns / 1e6:.3f} ms (first call per length included)")
    return eng, tally, launches, decode.calls


def warm_step_times(model, params, eng, prompt_lens, rng, tag: str) -> None:
    """Warm step times outside the trace: host time to enqueue the step vs
    time to its completion (equal when the host, not the card, bounds it)."""
    import torch

    for S in sorted(set(prompt_lens)):
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        host, done_ms = host_vs_device(lambda: model.prefill(params, {"tokens": toks}, 2048))
        print(f"[{tag}] prefill S={S}: {done_ms:.2f} ms to completion, host enqueue {host:.2f} ms (median of 5, warm)")
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.long, device=DEVICE)
    host, done_ms = host_vs_device(lambda: model.decode_step(params, eng.cache, {"token": tok}))
    print(f"[{tag}] decode step ({eng.cfg.batch_slots} slots): {done_ms:.2f} ms to completion, "
          f"host enqueue {host:.2f} ms (median of 5, warm)")


def init_full_width(arch: str, tag: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    # the config's analytic count leaves out parameters the spec tree
    # allocates (as the JAX package's does); the tensors follow the spec tree
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
          f"{_numel(params)} parameters (config formula: {cfg.active_params()}), "
          f"init {time.perf_counter() - t0:.1f} s")
    return model, params


def serve_full_width() -> dict:
    import numpy as np
    import torch

    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.serve import ServeConfig, ServeEngine

    model, params = init_full_width("mamba2-1.3b", "serve")
    cfg = model.cfg
    rng = np.random.default_rng(0)
    eng, _, launches, _ = traced_session(model, params, PROMPT_LENS, rng, "serve")
    n = len(PROMPT_LENS)
    if not torch.isfinite(eng.cache["state"].float()).all():
        raise AssertionError("non-finite SSM state")
    if launches["ssd_scan"] != cfg.num_layers * n:
        raise AssertionError(f"ssd_scan launches {launches['ssd_scan']} != {cfg.num_layers} x {n}")
    warm_step_times(model, params, eng, PROMPT_LENS, rng, "serve")
    # what the tracing costs: the same warm session untraced and traced, in
    # turns (off, default, default, off)
    for mode in ("off", "default", "default", "off"):
        e = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=2048, max_new_tokens=NEW_TOKENS))
        for S in PROMPT_LENS:
            e.submit(rng.integers(0, cfg.vocab_size, size=(S,)))
        d = tempfile.mkdtemp(prefix="thapi_overhead_")
        try:
            tracer = Tracer(TraceConfig(out_dir=d, mode=mode)) if mode != "off" else None
            if tracer is not None:
                tracer.start()
            t0 = time.perf_counter()
            try:
                e.run_until_drained()
                torch.cuda.synchronize()
            finally:
                if tracer is not None:
                    tracer.stop()
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        print(f"[overhead] warm session, trace {mode}: {n * NEW_TOKENS / wall:.2f} tokens/s ({wall:.3f} s)")
    return {"ssd_scan": launches["ssd_scan"]}


def serve_recurrentgemma() -> dict:
    """Full-width RecurrentGemma-2B: every prefill and every decode step runs
    the RG-LRU kernel once in each recurrent block."""
    import numpy as np
    import torch

    model, params = init_full_width("recurrentgemma-2b", "serve-rg")
    n_rec = model.cfg.block_counts()[1]
    rng = np.random.default_rng(1)
    eng, _, launches, steps = traced_session(model, params, RG_PROMPT_LENS, rng, "serve-rg")
    n = len(RG_PROMPT_LENS)
    hs = [st["h"] for key, st in eng.cache["groups"].items() if key.endswith("_rec")]
    hs += [st["h"] for st in eng.cache["tail"] if "h" in st]
    if not hs or not all(bool(torch.isfinite(h.float()).all()) for h in hs):
        raise AssertionError("non-finite RG-LRU state h")
    if launches["rglru_scan"] != n_rec * (n + steps):
        raise AssertionError(
            f"rglru_scan launches {launches['rglru_scan']} != {n_rec} x ({n} prefills + {steps} decode steps)"
        )
    print(f"[serve-rg] rglru_scan launches {launches['rglru_scan']} = {n_rec} recurrent blocks x "
          f"({n} prefills + {steps} decode steps); h leaves {sorted({str(h.dtype) for h in hs})}")
    warm_step_times(model, params, eng, RG_PROMPT_LENS, rng, "serve-rg")
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.long, device=DEVICE)
    profile_step(lambda: model.decode_step(params, eng.cache, {"token": tok}), "decode step (4 slots)", "serve-rg")
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, 1024)), device=DEVICE)
    profile_step(lambda: model.prefill(params, {"tokens": toks}, 2048), "prefill S=1024", "serve-rg")
    return {"rglru_scan": launches["rglru_scan"]}


# ---------------------------------------------------------------------------
# The full-mode polling fence, and the command-line entry point
# ---------------------------------------------------------------------------


def check_full_mode_fence() -> None:
    """In ``full`` mode a step on the card is fenced by polling its CUDA
    event: ``poll_ready`` pairs instead of ``block_until_ready``."""
    import torch

    from repro_torch.core import TracedStep, TraceConfig, Tracer
    from repro_torch.core.plugins.tally import tally_trace

    a = torch.randn(4096, 4096, device=DEVICE)
    step = TracedStep(lambda m: m @ m, name="matmul4096", device=DEVICE)
    trace_dir = tempfile.mkdtemp(prefix="thapi_full_")
    try:
        with Tracer(TraceConfig(out_dir=trace_dir, mode="full")):
            for _ in range(3):
                step(a)
        tally = tally_trace(trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    polls = tally.apis.get(("ust_repro", "poll_ready"))
    if polls is None or polls.calls < 3 or ("ust_torchrt", "block_until_ready") in tally.apis:
        raise AssertionError(f"full-mode fence: poll_ready rows {polls}")
    print(f"[fence] full mode: {polls.calls} poll_ready pairs over 3 fenced steps")


def serve_launcher() -> None:
    """The command a user runs, at full width under a trace, for each model:
    Mamba2 with 4 requests of 512 tokens, RecurrentGemma with its defaults
    (8 requests of 16 tokens, cache_len 64, so a 64-row ring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan, ssd_scan
    from repro_torch.launch import serve

    runs = [
        ("mamba2-1.3b", ["--requests", "4", "--prompt-len", "512", "--new-tokens", "8"]),
        ("recurrentgemma-2b", []),
    ]
    for arch, extra in runs:
        trace_dir = tempfile.mkdtemp(prefix="thapi_launch_")
        try:
            ssd_scan.launches = rglru_scan.launches = 0
            rc = serve.main(["--arch", arch, "--full", "--trace", "default", "--trace-dir", trace_dir, *extra])
            launches = {"ssd_scan": ssd_scan.launches, "rglru_scan": rglru_scan.launches}
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        cfg = get_config(arch)
        if arch == "mamba2-1.3b":
            ok = launches == {"ssd_scan": cfg.num_layers * 4, "rglru_scan": 0}
        else:  # 8 prefills and at least 7 decode steps, each through every recurrent block
            n_rec = cfg.block_counts()[1]
            ok = launches["ssd_scan"] == 0 and launches["rglru_scan"] % n_rec == 0 and (
                launches["rglru_scan"] >= n_rec * (8 + 7)
            )
        if rc != 0 or not ok:
            raise AssertionError(f"launcher {arch}: rc={rc}, launches {launches}")
        print(f"[launch] repro_torch.launch.serve --arch {arch} --full --trace default: rc 0, launches {launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)", file=sys.stderr)
        return 1
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    # Mamba2's phases first, in slice 1's order, so that their readings are
    # taken after the same work as before; then RecurrentGemma's
    kernels = [check_ssd()]
    check_model_against_cpu()
    launches = serve_full_width()
    kernels.append(check_rglru())
    check_hybrid_against_cpu()
    launches.update(serve_recurrentgemma())
    check_full_mode_fence()
    serve_launcher()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"kernel {k['name']} never ran on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
