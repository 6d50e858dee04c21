#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py                  # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --compare [SRC]  # this slice's readings, with the package under SRC

Phases, each fatal on failure:
  1. build every CUDA source under src/repro_torch/csrc/ (one nvcc each,
     all started together) and print the build time and the compiler's
     register and spill report;
  2. Mamba2-1.3B: count the HGMMA instructions of the bf16 SSD passes
     (each must hold some, where the toolkit has cuobjdump); hold the SSD
     scan kernel (bf16: three tensor-core passes; fp32: CUDA cores) against
     its plain PyTorch version at H=64, P=64, N=128 (one, four and sixteen
     chunks, a ragged 100-step chunk, a non-zero state0, three batch rows
     with two groups, and a steep decay, dt in (0.5, 2), at 512 and at a
     ragged 100; fp32 within 1e-4, bf16 within 2e-2) and time both, up to
     S=4096; hold a two-layer full-width model's prefill + decode on the
     card (kernel path) against the CPU (plain path) in fp32; serve the
     full-width model (48 layers, bf16, random weights from a seed) under a
     default-mode THAPI trace: 4 slots, prompts of 100, 256, 512 and 1024
     tokens, 16 new tokens each; tally the trace with the port's own tally
     and check that every prefill went through the kernel; time warm
     prefills (and a 4096-token one) and a decode step, and profile the
     decode step (the copy kernels' share) and the 1024- and 4096-token
     prefills (the SSD passes' share); then the tracing-overhead turns;
  3. RecurrentGemma-2B: hold the RG-LRU scan kernel (a time-chunked scan
     across a thread-block cluster) against its plain version at C=2560
     for (B, S) in (1,1), (4,1), (1,100), (1,1024), (1,3000), with h0
     absent, fp32 and bf16; at S=1024 and 3000 with the decays of the
     model's init (0.9 to 0.999), where h carries far; and at S = 129, 1025
     and 8192 (a cluster of two, a second round, eight rounds) (fp32 within
     2e-5, bf16 within 2e-2); time both, with the kernel's achieved HBM
     rate; hold a five-layer full-width model (one group and
     a two-block tail) on the card against the CPU in fp32; serve the
     full-width model (26 layers, bf16) the same way: cache_len 2048,
     prompts of 100, 512, 1024, 2040 (its ring wraps while decoding), 3000
     (longer than the window, so the prefill ring is rolled) and 512
     tokens; check that every prefill and every decode step went through
     the RG-LRU kernel in each of the 18 recurrent blocks; profile a warm
     decode step (the copy kernels' share) and the 1024- and 3000-token
     prefills (the RG-LRU kernel's share, 18 launches each).  Each serving run
     resets the launch counts just before it and reads them just after;
  4. h2o-danube-1.8b: count the HGMMA (wgmma) instructions in the SASS of
     each bf16 flash-attention instance (cuobjdump, where the toolkit has
     it; every bf16 instance must hold some); hold the flash-attention
     kernels (bf16: tensor cores; fp32: CUDA cores) against their plain
     version in fp32 and bf16 (the JAX kernel tests' six cases, non-causal,
     S > T under causal, a window without causal, a qwen-width MHA case at
     d=128 and danube's prefill shapes, H=32, Kv=8, d=80, window 4096, at
     S = 100, 1024, 4096 and 5000; fp32 within 2e-5 at the small shapes and
     1e-4 at full width; bf16 within 2e-2 + 2e-2·|o_ref| at the small
     shapes and 2e-3 + 2e-2·max|o_ref| of the row at full width) and time
     it in bf16 beside its
     plain version and the library's scaled_dot_product_attention (the
     yardstick only; the port never calls it); measure RoPE's frequencies,
     cos and sin on the card against the CPU and float64 up to position
     5000; hold a two-layer full-width model on the card against the CPU in
     fp32 (a 600-token prompt with cache_len 512, and a 5000-token one with
     cache_len 4096: rolled rings); serve the full-width model (24 layers,
     bf16) with cache_len 4096 (the ring is the window) and prompts of 100,
     512, 1024, 4096 (the ring is full, so decode wraps at once), 5000 (the
     prefill ring is rolled and the window masks inside the kernel) and 512
     tokens; check that every prefill ran the kernel in each of the 24
     layers and no decode step did; profile a warm decode step (the copy
     kernels' share) and the 4096- and 5000-token prefills, with the flash
     kernel's share of each prefill's device time;
  5. the full-mode polling fence, and the command-line launcher at full
     width under a trace, for the three models;
  6. iprof: ``python -m repro_torch.core.iprof run`` launches full-width
     RecurrentGemma-2B serving in its own process, then tally (one compile
     row for the decode step, one dispatch a step, the RG-LRU launches),
     validate, pretty, timeline, index and tally again; the same workload
     under --aggregate-only and under the tally-only rung tallies the same
     calls per API.
In phases 2-4 the ``[graph]`` phase also serves each full-width model with
the engine's decode step replaying its CUDA graph, against the eager
``decode_step`` on a clone of the cache at every step (tokens identical,
cache and logits within 1e-2 relative), and times the replay beside the
eager step.  The serving runs' launch counts are those that ran: a decode
graph's replays run the launches its capture recorded.
traced_session and warm_step_times take the serving cache_len (2048 unless
a phase says otherwise).
Prints the card's name and power limit first, a ``{"kernels": [...]}`` line
before the last, and ``{"ok": true, "device": {...}}`` last.  Exits non-zero,
printing no result, without a CUDA card or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
SSD_TIME_S = (100, 256, 512, 1024, 4096)
#: the CUDA kernels of one bf16 SSD call, each named in the device time
SSD_BF16_PASSES = ("ssd_scan_chunk_kernel", "ssd_scan_state_kernel", "ssd_scan_output_kernel")
PROMPT_LENS = (100, 256, 512, 1024, 100, 512)
#: a Mamba2 prompt long enough for the card, not the host, to bound its
#: prefill: timed warm and profiled, outside the traced session
MAMBA2_LONG_PROMPT = (4096,)
RG_PROMPT_LENS = (100, 512, 1024, 2040, 3000, 512)
DANUBE_PROMPT_LENS = (100, 512, 1024, 4096, 5000, 512)
DANUBE_CACHE_LEN = 4096
#: (prompt tokens, cache_len) of the two-layer danube card-against-CPU runs
DANUBE_CPU_CASES = ((600, 512), (5000, 4096))
NEW_TOKENS = 16
#: the CUDA kernels of one RG-LRU call, named in the device time: the chunked
#: scan, and for S <= 8 (decode) the step kernel (the one-thread-a-channel
#: kernel before them was rglru_scan_kernel)
RGLRU_KERNEL = "rglru_chunk_kernel"
RGLRU_STEP_KERNEL = "rglru_step_kernel"
#: (B, S) of the RG-LRU timings: decode over 1 and 4 slots, prefills
RGLRU_TIME_SHAPES = ((1, 1), (4, 1), (1, 100), (1, 1024), (1, 3000))
#: RecurrentGemma-2B prompts whose warm prefill is profiled (the RG-LRU share)
RG_PROFILE_LENS = (1024, 3000)
#: the [graph] phase's prompts (6 requests over 4 slots), each family
GRAPH_PROMPT_LENS = (100, 512, 1024, 256, 512, 100)
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


def _kernel_modules() -> tuple:
    from repro_torch.kernels import flash_attention, rglru_scan, ssd_scan

    return ssd_scan, rglru_scan, flash_attention


def _decode_graphs():
    """The decode-graph module of the tree under test, where it has one (a
    tree from before the decode graph runs every decode step eagerly)."""
    return sys.modules.get("repro_torch.serve.artifacts")


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0, and the decode graphs'
    counts of launches captured and replayed."""
    for mod in _kernel_modules():
        mod.launches = 0
    art = _decode_graphs()
    if art is not None:
        art.captured_launches.clear()
        art.replayed_launches.clear()


def read_launches() -> dict:
    """The launches of each kernel that ran: its wrapper's count (the eager
    calls, and the calls a decode graph's capture recorded without running
    them), less the launches captured, plus those that the graphs' replays
    ran (captured launches x replays)."""
    counts = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in _kernel_modules()}
    art = _decode_graphs()
    if art is None:
        return counts
    return {k: n - art.captured_launches.get(k, 0) + art.replayed_launches.get(k, 0) for k, n in counts.items()}


def launch_detail() -> str:
    art = _decode_graphs()
    if art is None:
        return ""
    wrappers = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in _kernel_modules()}
    return (f" (wrapper counts {wrappers}, captured into decode graphs {dict(art.captured_launches)}, "
            f"run by their replays {dict(art.replayed_launches)})")


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


def device_kernels(fn, reps: int = 20) -> dict:
    """(device ms per launch, launches recorded) of each device operation
    ``fn`` runs, by name, from a torch.profiler trace of ``reps`` warm
    calls.  A session now and then misses a launch that ran (one of twenty,
    most often), so the time is the mean over the launches it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {name: (ms / n, n) for name, (ms, n) in by_name.items()}


def kernel_device_ms(fn, kernels: tuple, reps: int = 20, tries: int = 3) -> dict:
    """Device time per call of each CUDA kernel in ``kernels`` (a part of
    the profiler's name; each launched once per call of ``fn``), by entry:
    the kernels' own run, without the host time of their wrapper that CUDA
    events around one call include when the host is slower than the card.
    A session that recorded no launch of one of them is taken again (and
    said so), up to ``tries`` sessions; raises if none recorded them all."""
    for attempt in range(1, tries + 1):
        seen = device_kernels(fn, reps)
        got = {k: [(ms, n) for name, (ms, n) in seen.items() if k in name] for k in kernels}
        missing = [k for k, v in got.items() if len(v) != 1]
        if not missing:
            short = {k: v[0][1] for k, v in got.items() if v[0][1] != reps}
            if short or attempt > 1:
                print(f"[profiler] {', '.join(kernels)}: session {attempt} of {tries} recorded them all"
                      + (f", launches {short} of {reps}" if short else ""))
            return {k: v[0][0] for k, v in got.items()}
        print(f"[profiler] session {attempt} of {tries}: {({k: len(got[k]) for k in missing})} kernels named "
              f"like these, want one each ({len(seen)} device operations)")
    raise AssertionError(f"the profiler recorded no single kernel named like each of {missing} in {tries} sessions")


def profile_step(fn, label: str, tag: str, kernels: tuple = (), launches: int = 0, tries: int = 3):
    """One warm call of ``fn`` under torch.profiler: wall time to completion,
    the card's busy time (the kernels' and copies' device intervals; one
    stream, so they do not overlap), its idle share, the kernels that take
    the most device time, and the share of the busy time taken by the
    device operations whose name holds an entry of ``kernels`` in any case
    ("copy" gathers the copy kernels and memcpys).  A session that records
    no device operation, none named like one of ``kernels``, or (when
    ``launches`` is given) other than ``launches`` of them, is taken again,
    up to ``tries`` sessions; raises if none recorded each of ``kernels``,
    and says so if none recorded all ``launches``.  Returns the busy ms (None
    when the profiler recorded no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = [k.lower() for k in kernels]
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        missing = [k for k in want if not any(k in e.name.lower() for e in dev)]
        mine = [e for e in dev if any(k in e.name.lower() for k in want)]
        if dev and not missing and (not launches or len(mine) == launches):
            break
        print(f"[{tag}] profile {label}: session {attempt} of {tries}: {len(dev)} device ops, {len(mine)} "
              f"launches named like {'/'.join(kernels)}" + (f" of {launches}" if launches else "")
              + (f", none like {missing}" if missing else ""))
    else:
        if missing:
            raise AssertionError(f"profile {label}: no session of {tries} recorded each of {kernels}")
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
    if want:
        ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        print(f"[{tag}] profile {label}: {'/'.join(kernels)} {ms:.3f} ms of the {busy:.2f} ms busy "
              f"({ms / busy:.3f}), {len(mine)} launches" + (f" of the {launches} that ran" if launches else ""))
    return busy


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


def ssd_inputs(S: int, dtype, with_state0: bool, seed: int, B: int = 1, G: int = 1, dt_range=(1e-3, 0.1)):
    """Mamba2-1.3B's SSD widths (H=64, P=64, N=128); ``dt_range`` (0.5, 2)
    is the steep decay, where cum falls below -88 within a few dozen rows."""
    import torch

    H, P, N = 64, 64, 128
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    dt = torch.empty(B, S, H, device=dev).uniform_(*dt_range, generator=g)
    A_log = torch.empty(H, device=dev).uniform_(0.0, 2.0, generator=g)
    Bm = torch.randn(B, S, G, N, generator=g, device=dev).to(dtype)
    Cm = torch.randn(B, S, G, N, generator=g, device=dev).to(dtype)
    D = torch.randn(H, generator=g, device=dev)
    state0 = torch.randn(B, H, P, N, generator=g, device=dev) if with_state0 else None
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


def ssd_time_rows(sizes) -> list:
    """Times at the serving path's shapes, one layer's prefill, bf16, batch
    1: (S, ms, device ms, plain ms, bound ms, bound by) for each S.  The
    device time sums the SSD_BF16_PASSES, each of which must be recorded:
    every kernel the wrapper launches."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    rows = []
    for S in sizes:
        chunk = min(256, S)
        x, dt, A_log, Bm, Cm, D, _ = ssd_inputs(S, torch.bfloat16, False, seed=7)
        call = lambda: ssd_scan.ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk)  # noqa: E731
        ms = cuda_ms(call)
        by_pass = kernel_device_ms(call, SSD_BF16_PASSES)
        dev = sum(by_pass.values())
        plain = cuda_ms(lambda: ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk))
        bound, by = ssd_bound(S, chunk, x, Bm, None)
        rows.append((S, ms, dev, plain, bound, by))
        print(
            f"[ssd-time] bf16 B=1 S={S} chunk={chunk}: kernel {ms:.4f} ms per call (CUDA events), "
            f"{dev:.4f} ms on the device (profiler; "
            + ", ".join(f"{n} {t:.4f}" for n, t in by_pass.items())
            + f"), plain {plain:.4f} ms, bound {bound:.5f} ms ({by})"
        )
    return rows


def check_ssd() -> dict:
    import torch

    from repro_torch.kernels import ref, ssd_scan

    hgmma = sass_hgmma("ssd_scan", r"(ssd_scan_(?:chunk|output)_kernel)")
    if hgmma and not (len(hgmma) == 2 and all(hgmma.values())):
        raise AssertionError(f"a bf16 SSD pass holds no HGMMA instruction: {hgmma}")
    steep = (0.5, 2.0)
    cases = [  # (B, S, G, chunk, state0, dt range)
        (1, 256, 1, 256, False, None),
        (1, 1024, 1, 256, False, None),
        (1, 100, 1, 100, False, None),
        (1, 1024, 1, 256, True, None),
        (1, 4096, 1, 256, True, None),
        (3, 512, 2, 256, True, None),
        (1, 512, 1, 256, True, steep),
        (1, 100, 1, 100, True, steep),
    ]
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = SSD_TOL[str(dtype).split(".")[1]]
        for i, (B, S, G, chunk, st0, dts) in enumerate(cases):
            x, dt, A_log, Bm, Cm, D, state0 = ssd_inputs(S, dtype, st0, i, B, G, dts or (1e-3, 0.1))
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
                f"[ssd] {dtype} B={B} S={S} G={G} chunk={chunk} state0={st0} dt={dts or 'mamba2'}: "
                f"max|dy|={err_y:.3g} max|dstate|={err_s:.3g} tol={tol} {'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with ssd_ref at S={S} {dtype}")
            max_err = max(max_err, err_y, err_s)

    rows = ssd_time_rows(SSD_TIME_S)
    # ms and plain_ms: medians of CUDA events around one call; device_ms:
    # the kernel's own time in a profiler trace
    S, ms, dev, plain, bound, by = rows[SSD_TIME_S.index(1024)]
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
        "hgmma": sum(hgmma.values()) if hgmma else "not measured",
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


def rglru_bytes(x, h0) -> int:
    """Bytes one call must move: x, r, i read and y written once, lam, h0 and h_last once."""
    B, _, C = x.shape
    return 4 * x.numel() * x.element_size() + C * 4 + B * C * 4 * (2 if h0 is not None else 1)


def rglru_bound(x, h0) -> tuple:
    """Least time for one call: ``rglru_bytes`` over HBM, and
    RGLRU_OPS_PER_ELEMENT fp32 operations per element over the fp32
    CUDA-core peak (none of it is a matrix product).  Returns (ms, bound_by)."""
    t_bytes = rglru_bytes(x, h0) / HBM_BYTES_PER_S
    t_ops = RGLRU_OPS_PER_ELEMENT * x.numel() / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rglru_kernel_name(B: int, S: int) -> str:
    """The CUDA kernel this tree's RG-LRU call launches at bf16 [B,S,2560]."""
    import torch

    from repro_torch.kernels import rglru_scan

    return RGLRU_STEP_KERNEL if rglru_scan.kernel_plan(torch.bfloat16, B, S, 2560)["step"] else RGLRU_KERNEL


def rglru_time_rows(shapes, kernel_of=rglru_kernel_name, plain: bool = True) -> dict:
    """Times at the serving path's shapes, bf16, C=2560: prefill (no h0) and
    decode (an fp32 h0, as the cache holds after the first step).  (B, S) ->
    (ms per call by CUDA events, device ms of the kernel ``kernel_of(B, S)``
    by the profiler, plain ms or None, bound ms, bound by); prints each with
    the achieved HBM rate (the bytes the call must move over its device
    time)."""
    import torch

    from repro_torch.kernels import ref, rglru_scan

    rows = {}
    for B, S in shapes:
        kernel = kernel_of(B, S)
        x, r, i, lam, h0 = rglru_inputs(B, S, torch.bfloat16, torch.float32 if S == 1 else None, 99)
        call = lambda: rglru_scan.rglru_scan(x, r, i, lam, h0=h0)  # noqa: E731
        ms = cuda_ms(call)
        dev = kernel_device_ms(call, (kernel,))[kernel]
        plain_ms = cuda_ms(lambda: ref.rglru_ref(x, r, i, lam, h0=h0)) if plain else None
        bound, by = rglru_bound(x, h0)
        rows[(B, S)] = (ms, dev, plain_ms, bound, by)
        print(
            f"[rglru-time] bf16 B={B} S={S} C=2560: kernel {ms:.4f} ms per call (CUDA events), "
            f"{dev:.4f} ms on the device (profiler, {kernel}), "
            f"{rglru_bytes(x, h0) / (dev * 1e-3) / 1e12:.3f} TB/s of the card's {HBM_BYTES_PER_S / 1e12:.2f}, "
            + (f"plain {plain_ms:.4f} ms, " if plain else "")
            + f"bound {bound:.5f} ms ({by})"
        )
    return rows


def check_rglru() -> dict:
    import torch

    from repro_torch.kernels import ref, rglru_scan

    shapes = RGLRU_TIME_SHAPES
    # (B, S, h0 dtype, long memory): every shape with Λ ~ N(0, 1), then the
    # long prompts with the decays of the model's init, where h carries far
    cases = [(B, S, h0, False) for B, S in shapes for h0 in (None, torch.float32, torch.bfloat16)]
    cases += [(1, S, h0, True) for S in (1024, 3000) for h0 in (None, torch.float32)]
    # one piece and a step (a cluster of two), a cluster span and a step (a
    # second round), and eight rounds
    cases += [(1, S, h0, False) for S in (129, 1025, 8192) for h0 in (None, torch.float32)]
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

    rows = rglru_time_rows(RGLRU_TIME_SHAPES)
    for B, S in RGLRU_TIME_SHAPES:
        plan = rglru_scan.kernel_plan(torch.bfloat16, B, S, 2560)
        print(f"[rglru-plan] bf16 B={B} S={S}: {'step' if plan['step'] else 'chunked'} kernel, "
              f"cluster {plan['cluster']}, rounds {plan['rounds']}, "
              f"grid ({plan['grid_x']}, {plan['grid_y']}) x {plan['threads']} threads")
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


FLASH_CASES = [  # B, S, T, H, Kv, d, causal, window, full width
    (1, 32, 32, 4, 4, 32, True, None, False),  # tests/test_kernels.py's six
    (2, 64, 64, 8, 2, 16, True, None, False),
    (2, 64, 64, 4, 1, 32, True, None, False),
    (1, 48, 48, 2, 2, 64, True, 16, False),
    (1, 16, 64, 4, 2, 32, True, None, False),
    (3, 128, 128, 2, 1, 8, True, 32, False),
    (2, 32, 32, 4, 2, 16, False, None, False),  # non-causal
    (1, 80, 40, 4, 2, 16, True, None, False),  # S > T: rows with no key give mean(v)
    (1, 96, 96, 4, 2, 32, False, 24, False),  # a window without causal
    (1, 1024, 1024, 40, 40, 128, True, None, True),  # qwen1.5-32b's MHA width
] + [(1, S, S, 32, 8, 80, True, 4096, True) for S in (100, 1024, 4096, 5000)]  # danube prefill
#: the prompt lengths at which the kernel is timed (danube's heads, window 4096)
FLASH_TIME_S = (1024, 4096, 5000)


def flash_close(o, o_ref, dtype, full: bool) -> tuple:
    """Whether the kernel's output ``o`` agrees with its plain version, and
    the limit it was held to.  fp32: within 2e-5 (1e-4 at full width, sums
    over up to 4096 keys) of each element.  bf16 at the small shapes: within
    2e-2 + 2e-2·|o_ref| of each element.  bf16 at full width: within
    2e-3 + 2e-2·max|o_ref| over the row.  Both round the probabilities to
    bf16 before PV, but the kernel keeps its scores in fp32 where the plain
    version's bf16 product rounds them, and it rounds unnormalised
    probabilities where the plain version rounds normalised ones, so their
    difference follows the size of the row's terms, not of its sum, which
    cancels: element-wise, rows of few keys need an atol of up to 7.5e-3,
    while an atol of 2e-2 is as large as a late row's |o| (~0.02 at S=4096,
    an average over thousands of keys) and would pass a fault there."""
    import torch

    o, o_ref = o.float(), o_ref.float()
    if dtype == torch.float32:
        tol = 1e-4 if full else 2e-5
        return torch.allclose(o, o_ref, rtol=tol, atol=tol), f"rtol=atol={tol}"
    if not full:
        return torch.allclose(o, o_ref, rtol=2e-2, atol=2e-2), "rtol=atol=0.02"
    limit = 2e-3 + 2e-2 * o_ref.abs().amax(dim=-1, keepdim=True)
    return bool(((o - o_ref).abs() <= limit).all()), "0.002 + 0.02 max|o_ref| of the row"


def flash_inputs(B, S, T, H, Kv, d, dtype, seed: int):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, S, H, d, generator=g, device=DEVICE).to(dtype)
    k = torch.randn(B, T, Kv, d, generator=g, device=DEVICE).to(dtype)
    v = torch.randn(B, T, Kv, d, generator=g, device=DEVICE).to(dtype)
    return q, k, v


def flash_pairs(S: int, T: int, causal: bool, window) -> int:
    """Kept (query, key) pairs of one head: query i sits at i + T - S."""
    import numpy as np

    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(q, k, causal: bool, window) -> tuple:
    """Least time for one call: q, k, v read and o written once over HBM;
    4 d FLOPs (QK^T and PV) per kept pair, head and batch entry over the bf16
    tensor-core peak (fp32: the CUDA-core peak).  Returns (ms, bound_by)."""
    B, S, H, d = q.shape
    T = k.shape[1]
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el
    flops = 4 * d * flash_pairs(S, T, causal, window) * H * B
    peak = BF16_FLOPS_PER_S if el == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, window):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (heads moved to dim 1 as views).  Its is_causal aligns the
    mask top-left, the kernel bottom-right: the same at S = T, which is all
    it is timed at.  Where the window bites (some query sits window or more
    past a key) it gets the kept set as a boolean mask instead."""
    import torch
    import torch.nn.functional as F

    S, T = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None or S <= window:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    band = (kpos <= qpos) & (kpos > qpos - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)


def sass_hgmma(lib: str, pattern: str) -> dict:
    """HGMMA (the SASS of wgmma) instructions in each function of the built
    ``lib<lib>.so`` whose mangled name matches ``pattern`` (its first group
    names the function), from ``cuobjdump -sass``; empty when the toolkit has
    no cuobjdump (printed as not measured)."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print(f"[sass] {lib}: no cuobjdump in the toolkit; HGMMA count not measured")
        return {}
    path = os.path.join(_build.BUILD_DIR, f"lib{lib}.so")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            fn = m.group(1) if m else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    print(f"[sass] {lib}: HGMMA instructions by function: {counts} (total {sum(counts.values())})")
    return counts


def hgmma_counts() -> dict:
    """HGMMA instructions in each bf16 flash-attention instance, by head
    width; every instance must hold some."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    counts = {int(d): n for d, n in sass_hgmma("flash_attention", r"flash_attention_wgmma_kernelILi(\d+)E").items()}
    if counts and (sorted(counts) != sorted(HEAD_DIMS) or not all(counts.values())):
        raise AssertionError(f"a bf16 flash-attention instance holds no HGMMA instruction: {counts}")
    return counts


def check_flash() -> dict:
    import torch

    from repro_torch.kernels import flash_attention, ref

    hgmma = hgmma_counts()
    max_err = 0.0
    seed = 100
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, T, H, Kv, d, causal, window, full in FLASH_CASES:
            seed += 1
            q, k, v = flash_inputs(B, S, T, H, Kv, d, dtype, seed)
            o = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            o_ref = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            close, limit = flash_close(o, o_ref, dtype, full)
            ok = o.dtype == dtype and bool(torch.isfinite(o).all()) and close
            if S > T and causal:  # rows before the first key: the mean of v, not 0
                mean_v = v.float().mean(dim=1).repeat_interleave(H // Kv, dim=1)
                ok = ok and flash_close(o[:, 0], mean_v, dtype, full)[0]
            print(
                f"[flash] {dtype} B={B} S={S} T={T} H={H} Kv={Kv} d={d} causal={causal} "
                f"window={window}: max|do|={err:.3g} tol {limit} {'ok' if ok else 'MISMATCH'}"
            )
            if not ok:
                raise AssertionError(f"flash_attention disagrees with flash_attention_ref at S={S} d={d} {dtype}")
            max_err = max(max_err, err)

    # times at the serving path's shapes: one layer's prefill of
    # h2o-danube-1.8b, bf16, batch 1, window 4096
    rows = {}
    for S in FLASH_TIME_S:
        q, k, v = flash_inputs(1, S, S, 32, 8, 80, torch.bfloat16, seed=7)
        call = lambda: flash_attention.flash_attention(q, k, v, causal=True, window=4096)  # noqa: E731
        ms = cuda_ms(call)
        dev = kernel_device_ms(call, ("flash_attention_wgmma_kernel",))["flash_attention_wgmma_kernel"]
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True, window=4096))
        lib = sdpa_call(q, k, v, 4096)
        lib_err = (lib().transpose(1, 2).float() - call().float()).abs().max().item()
        if lib_err > 2e-2:
            raise AssertionError(f"the library yardstick computes another function at S={S}: max|d|={lib_err:.3g}")
        library = cuda_ms(lib)
        bound, by = flash_bound(q, k, True, 4096)
        rows[S] = (ms, dev, plain, library, bound, by)
        print(
            f"[flash-time] bf16 B=1 S={S} H=32 Kv=8 d=80 window 4096: kernel {ms:.4f} ms per call (CUDA events), "
            f"{dev:.4f} ms on the device (profiler), plain {plain:.4f} ms, "
            f"library scaled_dot_product_attention {library:.4f} ms (max|d| vs kernel {lib_err:.3g}), "
            f"bound {bound:.5f} ms ({by}; {flash_pairs(S, S, True, 4096)} kept pairs per head)"
        )
        ran = sorted(device_kernels(lib, reps=5).items(), key=lambda kv: -kv[1][0])[:2]
        print(f"[flash-time] library S={S}, the device kernels that ran (ms per call, profiler): "
              + ("; ".join(f"{t:.4f} {name[:100]}" for name, (t, _) in ran) or "none recorded (not measured)"))
    ms, dev, plain, library, bound, by = rows[FLASH_TIME_S[1]]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:95",
        "launches": None,  # filled from the serving run
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library,
        "hgmma": sum(hgmma.values()) if hgmma else "not measured",
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


def check_rope_against_cpu() -> None:
    """Where the card and the CPU parted in RoPE'd keys, at positions
    0..5000 with h2o-danube-1.8b's theta and head width 80: the frequency
    formula ``exp(-log(theta) k / half)`` evaluated on each device (its
    argument and its exp apart), and ``layers.rope`` of a unit input (x1 =
    1, x2 = 0, so the output is [cos, sin] of its angles) on the card and on
    the CPU, each against float64 cos/sin of its own fp32 angles and
    against the float64 formula.  ``layers.rope`` takes its frequencies from
    the CPU on every device.  A measurement: it prints, and fails only on
    non-finite values."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import rope, rope_freqs

    cfg = get_config("h2o-danube-1.8b")
    theta, hd = cfg.rope_theta, cfg.head_dim_
    half, S = hd // 2, 5001
    eps = torch.finfo(torch.float32).eps

    def ulps(a, b):
        rel = (a - b).abs() / (eps * b.abs().clamp_min(torch.finfo(torch.float32).tiny))
        return f"{int((a != b).sum())} of {half} differ, max {rel.max().item():.2f} ulp"

    arg = {d: (-math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=d) / half) for d in (DEVICE, "cpu")}
    freqs = {d: torch.exp(a).cpu() for d, a in arg.items()}
    exp_of_cpu_arg = torch.exp(arg["cpu"].to(DEVICE)).cpu()
    print(f"[rope] danube theta {theta:g}, hd {hd}: the frequency formula on the card vs the cpu: "
          f"arguments {ulps(arg[DEVICE].cpu(), arg['cpu'])}; exp of the same arguments "
          f"{ulps(exp_of_cpu_arg, freqs['cpu'])}; frequencies {ulps(freqs[DEVICE], freqs['cpu'])}")
    pos = torch.arange(S)
    x = torch.zeros(1, S, 1, hd)
    x[..., :half] = 1.0
    out, own = {}, {}
    for dev in (DEVICE, "cpu"):
        out[dev] = rope(x.to(dev), pos.to(dev), theta)[0, :, 0].double().cpu()
        if not torch.isfinite(out[dev]).all():
            raise AssertionError(f"non-finite rope on {dev}")
        ang = (pos.float()[:, None] * rope_freqs(theta, half, torch.device("cpu"))).double()
        own[dev] = (out[dev] - torch.cat([torch.cos(ang), torch.sin(ang)], -1)).abs().max().item()
    exact_f = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float64) / half)
    exact = torch.cat([torch.cos(pos.double()[:, None] * exact_f), torch.sin(pos.double()[:, None] * exact_f)], -1)
    d = (out[DEVICE] - out["cpu"]).abs()
    print(f"[rope] layers.rope cos/sin card vs cpu, positions 0..{S - 1}: max|d| {d.max().item():.3g} "
          f"({d[:601].max().item():.3g} up to 600); each against float64 cos/sin of its fp32 angles: "
          f"card {own[DEVICE]:.3g}, cpu {own['cpu']:.3g}; against the float64 formula: "
          f"card {(out[DEVICE] - exact).abs().max().item():.3g}, cpu {(out['cpu'] - exact).abs().max().item():.3g}")


def check_dense_against_cpu(S: int, cache_len: int) -> None:
    """Two full-width h2o-danube-1.8b layers, fp32: an S-token prompt with
    ``cache_len`` rows (600 and 512: the prefill ring is rolled; 5000 and
    4096: danube's window masks inside the prompt and the ring is rolled)
    and two decode steps, card (kernel) against CPU (plain) over logits and
    every cache leaf."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.layers import layer_slice, qkv

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(3))
    params_cpu = _to(params, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, S))
    # the kernel takes contiguous tensors: the projections' einsum gives them
    x = params["embed"]["tok"][torch.as_tensor(toks, device=DEVICE)]
    q, k, v = qkv(cfg, layer_slice(params["blocks"], 0)["attn"], x, torch.arange(S, device=DEVICE)[None])
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise AssertionError(f"non-contiguous projections: strides {q.stride()}, {k.stride()}, {v.stride()}")
    print(f"[model-dn] q, k, v from the projections are contiguous (v strides {v.stride()})")
    out = {}
    for dev, p in ((DEVICE, params), ("cpu", params_cpu)):
        logits, cache = model.prefill(p, {"tokens": torch.as_tensor(toks, device=dev)}, cache_len)
        steps = [logits]
        tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        for _ in range(2):
            logits, cache = model.decode_step(p, cache, {"token": tok})
            steps.append(logits)
            tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        out[dev] = [t.float().cpu() for t in steps] + [t.float().cpu() for t in _leaves(cache)]
    names = ["prefill", "decode1", "decode2", "cache k", "cache v", "cache len"]
    errs = []
    for name, a, b in zip(names, out[DEVICE], out["cpu"], strict=True):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} on the card")
        errs.append(f"{name} {(a - b).abs().max().item():.3g} (|x| up to {b.abs().max().item():.3g})")
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"card and CPU disagree on {name} at S={S}: max|d|={(a - b).abs().max().item():.3g}")
    print(f"[model-dn] 2-layer full-width fp32, {S}-token prompt, cache_len {cache_len} (rolled ring), card vs cpu "
          f"max|d| (tol 1e-3): {'; '.join(errs)} ok")


# ---------------------------------------------------------------------------
# Full-width traced serving
# ---------------------------------------------------------------------------


def traced_session(model, params, prompt_lens, rng, tag: str, cache_len: int = 2048):
    """Serve one request per prompt length (4 slots, ``cache_len``,
    NEW_TOKENS each) under a default-mode trace.  The kernels' launch counts
    are set to 0 just before the run and read just after it.  Checks what
    every serving run must show; returns (engine, tally, launches, decode
    steps)."""
    import torch

    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import render, tally_trace
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = model.cfg
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=cache_len, max_new_tokens=NEW_TOKENS))
    for S in prompt_lens:
        eng.submit(rng.integers(0, cfg.vocab_size, size=(S,)))
    trace_dir = tempfile.mkdtemp(prefix="thapi_smoke_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_alloc = torch.cuda.memory_allocated()
        reset_launches()
        with Tracer(TraceConfig(out_dir=trace_dir, mode="default")):
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        detail = launch_detail()
        peak = torch.cuda.max_memory_allocated()
        end_alloc = torch.cuda.memory_allocated()
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
          f"{decode.calls} decode steps; peak device memory {peak / 2**30:.3f} GiB (allocated at the start "
          f"{start_alloc / 2**30:.3f} GiB, at the end {end_alloc / 2**30:.3f} GiB); "
          f"launches {launches}{detail}")
    for (prov, name), st in sorted(tally.device_apis.items()):
        if name.startswith("prefill[") or name.startswith("decode_step["):
            print(f"[{tag}] traced {name}: {st.calls} call(s), avg {st.avg_ns / 1e6:.3f} ms (first call per length included)")
    return eng, tally, launches, decode.calls


def warm_step_times(model, params, eng, prompt_lens, rng, tag: str, cache_len: int = 2048) -> None:
    """Warm step times outside the trace: host time to enqueue the step vs
    time to its completion (equal when the host, not the card, bounds it)."""
    import torch

    for S in sorted(set(prompt_lens)):
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        host, done_ms = host_vs_device(lambda: model.prefill(params, {"tokens": toks}, cache_len))
        print(f"[{tag}] prefill S={S}: {done_ms:.2f} ms to completion, host enqueue {host:.2f} ms (median of 5, warm)")
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.int32, device=DEVICE)
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
    warm_step_times(model, params, eng, PROMPT_LENS + MAMBA2_LONG_PROMPT, rng, "serve")
    graph_phase(model, params, GRAPH_PROMPT_LENS, rng, "mamba2", long_prompt=4096)
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.int32, device=DEVICE)
    profile_step(lambda: model.decode_step(params, eng.cache, {"token": tok}), "decode step (4 slots)", "serve",
                 kernels=("copy",))
    mamba2_prefill_profiles(model, params, rng, "serve")
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


def mamba2_prefill_profiles(model, params, rng, tag: str) -> None:
    """Warm Mamba2 prefills of 1024 and 4096 tokens under the profiler: busy
    time, idle share and the share of the SSD_BF16_PASSES."""
    import torch

    for S in (1024,) + MAMBA2_LONG_PROMPT:
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        profile_step(lambda t=toks: model.prefill(params, {"tokens": t}, 2048), f"prefill S={S}", tag,
                     kernels=SSD_BF16_PASSES, launches=model.cfg.num_layers * len(SSD_BF16_PASSES))


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
    graph_phase(model, params, GRAPH_PROMPT_LENS, rng, "recurrentgemma")
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.int32, device=DEVICE)
    profile_step(lambda: model.decode_step(params, eng.cache, {"token": tok}), "decode step (4 slots)", "serve-rg",
                 kernels=("copy",))
    rg_prefill_profiles(model, params, rng, "serve-rg")
    return {"rglru_scan": launches["rglru_scan"]}


def rg_prefill_profiles(model, params, rng, tag: str, kernel: str = RGLRU_KERNEL) -> None:
    """Warm RecurrentGemma-2B prefills of RG_PROFILE_LENS tokens under the
    profiler: busy time, idle share and the share of the RG-LRU kernel,
    launched once in each recurrent block."""
    import torch

    n_rec = model.cfg.block_counts()[1]
    for S in RG_PROFILE_LENS:
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        profile_step(lambda t=toks: model.prefill(params, {"tokens": t}, 2048), f"prefill S={S}", tag,
                     kernels=(kernel,), launches=n_rec)


def serve_danube() -> dict:
    """Full-width h2o-danube-1.8b: every prefill runs the flash-attention
    kernel once in each layer; decode attends with the plain ``attend``."""
    import numpy as np
    import torch

    model, params = init_full_width("h2o-danube-1.8b", "serve-dn")
    L = model.cfg.num_layers
    rng = np.random.default_rng(2)
    eng, _, launches, steps = traced_session(
        model, params, DANUBE_PROMPT_LENS, rng, "serve-dn", cache_len=DANUBE_CACHE_LEN
    )
    n = len(DANUBE_PROMPT_LENS)
    if eng.cache["k"].shape[2] != DANUBE_CACHE_LEN:
        raise AssertionError(f"ring of {eng.cache['k'].shape[2]} rows, want {DANUBE_CACHE_LEN}")
    if not (torch.isfinite(eng.cache["k"].float()).all() and torch.isfinite(eng.cache["v"].float()).all()):
        raise AssertionError("non-finite k/v cache")
    if launches != {"ssd_scan": 0, "rglru_scan": 0, "flash_attention": L * n}:
        raise AssertionError(f"launches {launches}: want flash_attention = {L} layers x {n} prefills, no other kernel")
    print(f"[serve-dn] flash_attention launches {launches['flash_attention']} = {L} layers x {n} prefills "
          f"(none in the {steps} decode steps)")
    warm_step_times(model, params, eng, DANUBE_PROMPT_LENS, rng, "serve-dn", cache_len=DANUBE_CACHE_LEN)
    graph_phase(model, params, GRAPH_PROMPT_LENS, rng, "danube", cache_len=DANUBE_CACHE_LEN, long_prompt=5000)
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.int32, device=DEVICE)
    profile_step(lambda: model.decode_step(params, eng.cache, {"token": tok}), "decode step (4 slots)", "serve-dn",
                 kernels=("copy",))
    for S in (4096, 5000):
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        profile_step(lambda t=toks: model.prefill(params, {"tokens": t}, DANUBE_CACHE_LEN), f"prefill S={S}",
                     "serve-dn", kernels=("flash_attention_wgmma_kernel",), launches=L)
    return {"flash_attention": launches["flash_attention"]}


# ---------------------------------------------------------------------------
# The decode step as a CUDA graph
# ---------------------------------------------------------------------------

#: the [graph] phase: 6 requests over 4 slots, GRAPH_NEW_TOKENS each, so two
#: slots are refilled between decode steps
GRAPH_NEW_TOKENS = 8
GRAPH_TOL = 1e-2  # relative, bf16: cuBLAS may choose another algorithm under capture
GRAPH_PROFILE_REPLAYS = 3


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def graph_phase(model, params, prompt_lens, rng, tag: str, cache_len: int = 2048, long_prompt: int = 3000) -> None:
    """The engine's decode step replays its CUDA graph: before every decode
    step the cache and token buffer are cloned, the engine steps (its first
    step runs eagerly and captures the graph) and ``model.decode_step`` runs
    eagerly on the clone.  Greedy tokens must be identical, every cache leaf
    and the replay's logits within GRAPH_TOL relative; at least 8 steps with
    a slot refill between two of them.  Then the replay's and the eager
    step's time to completion, host enqueue time and idle share, the memory
    the capture kept, and the RG-LRU step kernel's launches over a few
    replays under the profiler against the launches captured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.artifacts import DecodeGraph

    V = model.cfg.vocab_size
    long_toks = torch.as_tensor(rng.integers(0, V, size=(1, long_prompt)), device=DEVICE)

    def prefill_peak() -> float:
        """MiB that a warm ``long_prompt`` prefill adds at its peak to what is allocated."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.prefill(params, {"tokens": long_toks}, cache_len)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    peak_before = prefill_peak()
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=cache_len, max_new_tokens=GRAPH_NEW_TOKENS))
    if not isinstance(eng.decode_fn, DecodeGraph):
        raise AssertionError(f"the engine's decode step is {eng.decode_fn!r}, not a DecodeGraph")
    for S in prompt_lens:
        eng.submit(rng.integers(0, V, size=(S,)))
    steps, refilled_at, worst, mem = 0, [], {"logits": 0.0, "cache": 0.0}, None
    while True:
        before = sum(s is not None for s in eng.slots)
        eng._fill_slots()  # refill first, so the clone sees what the step sees
        if not any(s is not None for s in eng.slots):
            break
        if steps and sum(s is not None for s in eng.slots) > before:
            refilled_at.append(steps)
        cache, tok = _clone(eng.cache), eng._tok.clone()
        if steps == 0:
            torch.cuda.synchronize()
            mem = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        eng.step()
        if steps == 0:
            torch.cuda.synchronize()
            mem = (torch.cuda.memory_allocated() - mem[0], torch.cuda.memory_reserved() - mem[1])
        steps += 1
        logits, cache = model.decode_step(params, cache, {"token": tok})
        want = torch.argmax(logits[:, 0, :V], dim=-1).to(torch.int32)
        if not torch.equal(eng._tok, want):
            raise AssertionError(f"[{tag}] decode step {steps}: replayed tokens {eng._tok.tolist()} != eager {want.tolist()}")
        if steps > 1:
            worst["logits"] = max(worst["logits"], _rel(eng.decode_fn._out[0], logits))
        for got, ref in zip(_leaves(eng.cache), _leaves(cache), strict=True):
            if got.dtype != ref.dtype:
                raise AssertionError(f"[{tag}] cache leaf dtype {got.dtype} != eager {ref.dtype}")
            worst["cache"] = max(worst["cache"], _rel(got, ref))
    g = eng.decode_fn
    if steps < 8 or not refilled_at or g.replays != steps - 1:
        raise AssertionError(f"[{tag}] graph: {steps} steps, refills at {refilled_at}, {g.replays} replays")
    if max(worst.values()) > GRAPH_TOL:
        raise AssertionError(f"[{tag}] graph against eager: largest relative difference {worst} > {GRAPH_TOL}")
    print(f"[graph] {tag}: a warm {long_prompt}-token prefill adds {peak_before:.1f} MiB at its peak before the "
          f"engine exists and {prefill_peak():.1f} MiB with the engine's graph captured")
    print(f"[graph] {tag}: {steps} decode steps ({g.replays} replays of the captured graph), slots refilled "
          f"before steps {[k + 1 for k in refilled_at]}; tokens identical to the eager step; largest relative "
          f"difference logits {worst['logits']:.3g}, cache {worst['cache']:.3g} (tol {GRAPH_TOL}); launches "
          f"captured {g.captured}; the first step (eager + capture) kept {mem[0] / 2**20:.1f} MiB allocated, "
          f"{mem[1] / 2**20:.1f} MiB reserved")

    batch = {"token": eng._tok}
    host, done_ms = host_vs_device(lambda: g(params, eng.cache, batch))
    ehost, edone = host_vs_device(lambda: model.decode_step(params, eng.cache, batch))
    print(f"[graph] {tag}: decode step (4 slots): replay {done_ms:.2f} ms to completion, host enqueue "
          f"{host:.3f} ms; eager {edone:.2f} ms to completion, host enqueue {ehost:.2f} ms (medians of 5, warm)")
    busy = profile_step(lambda: g(params, eng.cache, batch), "decode step, replay (4 slots)", f"graph {tag}")
    ebusy = profile_step(lambda: model.decode_step(params, eng.cache, batch), "decode step, eager (4 slots)",
                         f"graph {tag}")
    if busy and ebusy:
        # the profiler's tracing of each kernel widens a graph's gaps, so the
        # share is also read against the step's time to completion without it
        print(f"[graph] {tag}: idle share against the time to completion without the profiler: replay "
              f"{1 - busy / done_ms:.3f}, eager {1 - ebusy / edone:.3f}")

    n_rec = g.captured.get("rglru_scan", 0)
    want = {"rglru_scan": model.cfg.block_counts()[1]} if model.cfg.family == "hybrid" else {}
    if g.captured != want:
        raise AssertionError(f"[{tag}] launches captured {g.captured}, want {want}")
    if n_rec:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(GRAPH_PROFILE_REPLAYS):
                g.graph.replay()
            torch.cuda.synchronize()
        seen = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and RGLRU_STEP_KERNEL in e.name)
        if seen != n_rec * GRAPH_PROFILE_REPLAYS:
            raise AssertionError(f"[{tag}] the profiler saw {seen} {RGLRU_STEP_KERNEL} launches in "
                                 f"{GRAPH_PROFILE_REPLAYS} replays, want {n_rec} x {GRAPH_PROFILE_REPLAYS}")
        print(f"[graph] {tag}: the profiler saw {seen} {RGLRU_STEP_KERNEL} launches in {GRAPH_PROFILE_REPLAYS} "
              f"replays = {n_rec} captured x {GRAPH_PROFILE_REPLAYS}")
    try:
        g(params, _clone(eng.cache), batch)
    except RuntimeError as e:
        print(f"[graph] {tag}: a call with other storages raises: {e}")
    else:
        raise AssertionError(f"[{tag}] the decode graph replayed over other storages")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


# ---------------------------------------------------------------------------
# iprof: launch traced serving, then analyse the trace offline and online
# ---------------------------------------------------------------------------

IPROF_TARGET = ["repro_torch.launch.serve:main", "--arch", "recurrentgemma-2b", "--full", "--requests", "6",
                "--new-tokens", "16", "--cache-len", "2048", "--prompt-len", "512"]


def _iprof_run(out: str, *flags: str) -> None:
    """``python -m repro_torch.core.iprof run`` in its own process, as a user runs it."""
    cmd = [sys.executable, "-m", "repro_torch.core.iprof", "run", "-m", "default", "-o", out, *flags, "--",
           *IPROF_TARGET]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    for line in proc.stdout.splitlines():
        print(f"[iprof] run {' '.join(flags) or '(default)'}: {line}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"iprof run {flags} exited {proc.returncode}")
    print(f"[iprof] run {' '.join(flags) or '(default)'}: {time.perf_counter() - t0:.1f} s in its own process")


def _iprof(*argv: str) -> tuple:
    """(exit code, standard output) of one in-process iprof analysis command."""
    import contextlib
    import io

    from repro_torch.core.iprof import main as iprof

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = iprof(list(argv))
    return rc, buf.getvalue()


def _calls(t) -> dict:
    return {**{k: s.calls for k, s in t.apis.items()}, **{("device",) + k: s.calls for k, s in t.device_apis.items()}}


def iprof_phase() -> None:
    """iprof launches full-width RecurrentGemma-2B serving (its decode step
    replays the graph that holds the RG-LRU step kernel 18 times), then
    tallies, validates, pretty-prints, exports the timeline, indexes and
    tallies again; the same workload under --aggregate-only and under the
    tally-only rung gives the same calls per API."""
    from repro_torch.configs import get_config
    from repro_torch.core.aggregate import load_tally
    from repro_torch.core.babeltrace import CTFSource
    from repro_torch.core.plugins.tally import tally_trace

    n_rec = get_config("recurrentgemma-2b").block_counts()[1]
    root = tempfile.mkdtemp(prefix="thapi_iprof_")
    try:
        d = os.path.join(root, "default")
        _iprof_run(d)
        rc, tally_text = _iprof("tally", d)
        print(tally_text, end="")
        t = tally_trace(d)
        rows = {"compile": {}, "dispatch": {}}
        for e in CTFSource(d):
            for api, by_fn in rows.items():
                if e.name == f"ust_torchrt:{api}_entry":
                    fn = e.field("fn").split("[")[0]
                    by_fn[fn] = by_fn.get(fn, 0) + 1
        prefills = t.apis[("ust_repro", "prefill")].calls
        steps = t.apis[("ust_repro", "decode_step")].calls
        spans = t.device_apis[("ust_kernel", "rglru_scan")].calls
        # spans fire where the wrapper runs: each prefill, the eager first
        # decode step and the capture; the replays run what the capture holds
        launched = spans - n_rec + n_rec * (steps - 1)
        ok = (rc == 0 and rows["compile"].get("decode_step") == 1 and rows["dispatch"].get("decode_step") == steps
              and prefills == 6 and spans == n_rec * (prefills + 2) and launched == n_rec * (prefills + steps))
        print(f"[iprof] tally: rc {rc}; compile rows {rows['compile']}, dispatch rows {rows['dispatch']}; "
              f"{prefills} prefills, {steps} decode steps; rglru_scan spans {spans} = {n_rec} x ({prefills} "
              f"prefills + the eager step + the capture), so {launched} launches ran = {n_rec} x ({prefills} + "
              f"{steps})")
        if not ok:
            raise AssertionError("iprof tally: the rows above break a gate")
        rc, text = _iprof("validate", d)
        print(f"[iprof] validate: rc {rc}: {text.strip()}")
        if rc != 0 or "[error]" in text:
            raise AssertionError("iprof validate found an error")
        rc, text = _iprof("pretty", d, "-n", "20")
        lines = text.splitlines()
        print(f"[iprof] pretty -n 20: rc {rc}, {len(lines)} lines; the first: {lines[0][:160] if lines else ''}")
        if rc != 0 or len(lines) != 20:
            raise AssertionError("iprof pretty")
        tl = os.path.join(root, "timeline.json")
        rc, text = _iprof("timeline", d, "-o", tl)
        n_tl = len(json.load(open(tl))["traceEvents"])
        print(f"[iprof] timeline: rc {rc}, {n_tl} events, {os.path.getsize(tl)} bytes")
        if rc != 0 or not n_tl:
            raise AssertionError("iprof timeline")
        rc, text = _iprof("index", d)
        rc2, again = _iprof("tally", d)
        print(f"[iprof] index: rc {rc}: {text.strip()}; tally through the sidecars "
              f"{'identical' if again == tally_text else 'DIFFERS'}")
        if rc != 0 or rc2 != 0 or again != tally_text:
            raise AssertionError("iprof tally after index differs")
        want = _calls(t)
        for flags, what in ((("--aggregate-only",), "aggregate"), (("--fidelity", "tally-only"), "online analyser")):
            dd = os.path.join(root, flags[-1].lstrip("-"))
            _iprof_run(dd, *flags)
            got = _calls(load_tally(os.path.join(dd, "aggregate_rank0.tally")))
            rc, text = _iprof("combine", dd)
            leftover = [f for f in os.listdir(dd) if f.endswith((".ctf", ".ctfcol"))]
            print(f"[iprof] {' '.join(flags)}: combine rc {rc}; the {what}'s tally has "
                  f"{'the same' if got == want else 'OTHER'} calls per API as the default run's offline tally "
                  f"({sum(got.values())} calls in {len(got)} rows); {len(leftover)} stream files left")
            if rc != 0 or got != want or leftover:
                raise AssertionError(f"iprof {flags}: {got} != {want}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    Mamba2 with 4 requests of 512 tokens, RecurrentGemma and h2o-danube with
    the defaults (8 requests of 16 tokens, cache_len 64, so a 64-row ring)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    runs = [
        ("mamba2-1.3b", ["--requests", "4", "--prompt-len", "512", "--new-tokens", "8"]),
        ("recurrentgemma-2b", []),
        ("h2o-danube-1.8b", []),
    ]
    for arch, extra in runs:
        trace_dir = tempfile.mkdtemp(prefix="thapi_launch_")
        try:
            reset_launches()
            rc = serve.main(["--arch", arch, "--full", "--trace", "default", "--trace-dir", trace_dir, *extra])
            launches = read_launches()
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        cfg = get_config(arch)
        if arch == "mamba2-1.3b":
            ok = launches == {"ssd_scan": cfg.num_layers * 4, "rglru_scan": 0, "flash_attention": 0}
        elif arch == "h2o-danube-1.8b":  # 8 prefills, each through every layer
            ok = launches == {"ssd_scan": 0, "rglru_scan": 0, "flash_attention": cfg.num_layers * 8}
        else:  # 8 prefills and at least 7 decode steps, each through every recurrent block
            n_rec = cfg.block_counts()[1]
            ok = launches["ssd_scan"] == launches["flash_attention"] == 0 and launches["rglru_scan"] % n_rec == 0 and (
                launches["rglru_scan"] >= n_rec * (8 + 7)
            )
        if rc != 0 or not ok:
            raise AssertionError(f"launcher {arch}: rc={rc}, launches {launches}")
        print(f"[launch] repro_torch.launch.serve --arch {arch} --full --trace default: rc 0, launches {launches}"
              f"{launch_detail()}")


def compare_only(src: str) -> int:
    """``--compare [SRC]``: the readings this slice moved, with the package
    under ``SRC``, a directory inside this checkout (default: its own
    ``src``; a parent tree goes unpacked under the gitignored ``build/``),
    so that two trees run the same measuring code in one call: the RG-LRU
    kernel's times at (B, S) = (1, 1), (4, 1), (1, 1024) and (1, 3000) (a
    tree from before the time-chunked scan runs ``rglru_scan_kernel`` at
    every S); the
    full-width RecurrentGemma-2B prefills of 1024 and 3000 tokens (warm
    times and profiles, the RG-LRU share); and its traced session's
    tokens/s."""
    import numpy as np
    import torch

    root, src = os.path.realpath(ROOT), os.path.realpath(src)
    if os.path.commonpath([root, src]) != root:
        print(f"chip_smoke: --compare takes a tree inside the checkout, not {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import rglru_scan

    print(f"[compare] {rglru_scan.__file__}")
    new = hasattr(rglru_scan, "kernel_plan")
    torch.backends.cuda.matmul.allow_tf32 = False
    rglru_time_rows(((1, 1), (4, 1), (1, 1024), (1, 3000)),
                    rglru_kernel_name if new else (lambda B, S: "rglru_scan_kernel"), plain=False)
    model, params = init_full_width("recurrentgemma-2b", "compare")
    rng = np.random.default_rng(1)
    for S in RG_PROFILE_LENS:
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        host, done_ms = host_vs_device(lambda t=toks: model.prefill(params, {"tokens": t}, 2048))
        print(f"[compare] prefill S={S}: {done_ms:.2f} ms to completion, host enqueue {host:.2f} ms "
              f"(median of 5, warm)")
    rg_prefill_profiles(model, params, rng, "compare", RGLRU_KERNEL if new else "rglru_scan_kernel")
    traced_session(model, params, RG_PROMPT_LENS, rng, "compare")
    return 0


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)", file=sys.stderr)
        return 1
    print(card_line())
    if argv[:1] == ["--compare"]:
        return compare_only(argv[1] if len(argv) > 1 else os.path.join(ROOT, "src"))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    # Mamba2's phases first, in slice 1's order, so that their readings are
    # taken after the same work as before; then RecurrentGemma's, then
    # h2o-danube-1.8b's
    kernels = [check_ssd()]
    check_model_against_cpu()
    launches = serve_full_width()
    kernels.append(check_rglru())
    check_hybrid_against_cpu()
    launches.update(serve_recurrentgemma())
    kernels.append(check_flash())
    check_rope_against_cpu()
    for S, cache_len in DANUBE_CPU_CASES:
        check_dense_against_cpu(S, cache_len)
    launches.update(serve_danube())
    check_full_mode_fence()
    serve_launcher()
    iprof_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"kernel {k['name']} never ran on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
