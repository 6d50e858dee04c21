#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each fatal on failure:
  1. build every CUDA source under src/repro_torch/csrc/ (one nvcc each)
     and print the build time and the compiler's register and spill report;
  2. hold each hand-written kernel against its plain PyTorch version on the
     card at the serving path's shapes (SSD scan: Mamba2-1.3B's H=64, P=64,
     G=1, N=128; one and four chunks, a ragged 100-step chunk, a non-zero
     state0; fp32 within 1e-4, bf16 within 2e-2), and time both;
  3. hold a two-layer full-width Mamba2-1.3B prefill + decode on the card
     (kernel path) against the same weights on the CPU (plain path) in fp32;
  4. serve full-width Mamba2-1.3B (48 layers, bf16, random weights from a
     seed) under a default-mode THAPI trace: 4 slots, prompts of 100, 256,
     512 and 1024 tokens, 16 new tokens each; tally the trace with the
     port's own tally and check that every prefill went through the kernel
     (the launch counts are reset just before this run and read just after);
  5. run the command-line launcher at full width under a trace.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: published H100 SXM peaks (NVIDIA data sheet), for the bound column
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

DEVICE = "cuda"
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT_LENS = (100, 256, 512, 1024, 100, 512)
NEW_TOKENS = 16


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


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


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    from repro_torch.kernels import _build

    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    t0 = time.perf_counter()
    for name in names:
        print(f"[build] {name} -> {os.path.relpath(_build.build(name), ROOT)}")
    print(f"[build] {len(names)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[ptxas] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 2. kernel against its plain version
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
        ms = cuda_ms(lambda: ssd_scan.ssd_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk))
        plain = cuda_ms(lambda: ref.ssd_ref(x, dt, A_log, Bm, Cm, D, chunk=chunk))
        bound, by = ssd_bound(S, chunk, x, Bm, None)
        rows.append((S, ms, plain, bound, by))
        print(
            f"[ssd-time] bf16 B=1 S={S} chunk={chunk}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bound:.5f} ms ({by})"
        )
    S, ms, plain, bound, by = rows[-1]
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:58",
        "launches": None,  # filled from the serving run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes the SSD scan
    }


# ---------------------------------------------------------------------------
# 3. full-width model on the card against the CPU
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


# ---------------------------------------------------------------------------
# 4. full-width traced serving
# ---------------------------------------------------------------------------


def serve_full_width() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import render, tally_trace
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = _numel(params)
    # the config's analytic count leaves out dt_bias, norm_g and ln_f (as the
    # JAX package's does); the tensors are what the spec tree declares
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
          f"{n_params} parameters (config formula: {cfg.active_params()}), "
          f"init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=2048, max_new_tokens=NEW_TOKENS))
    rng = np.random.default_rng(0)
    for S in PROMPT_LENS:
        eng.submit(rng.integers(0, cfg.vocab_size, size=(S,)))
    trace_dir = tempfile.mkdtemp(prefix="thapi_smoke_")
    try:
        torch.cuda.reset_peak_memory_stats()
        ssd_scan.launches = 0
        with Tracer(TraceConfig(out_dir=trace_dir, mode="default")):
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = ssd_scan.launches
        peak = torch.cuda.max_memory_allocated()
        tally = tally_trace(trace_dir)
        print(render(tally, top=12))
        print(render(tally, top=12, device=True))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    n = len(PROMPT_LENS)
    if len(done) != n or any(len(r.out_tokens) != NEW_TOKENS for r in done):
        raise AssertionError("not every request got its tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError("token outside the vocabulary")
    if not torch.isfinite(eng.cache["state"].float()).all():
        raise AssertionError("non-finite SSM state")
    prefill = tally.apis.get(("ust_repro", "prefill"))
    decode = tally.apis.get(("ust_repro", "decode_step"))
    if prefill is None or prefill.calls != n:
        raise AssertionError(f"ust_repro:prefill rows {prefill} != {n} requests")
    if decode is None or decode.calls == 0:
        raise AssertionError("no ust_repro:decode_step rows")
    if launches != cfg.num_layers * n:
        raise AssertionError(f"ssd_scan launches {launches} != {cfg.num_layers} x {n}")
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {n} requests, {tokens} tokens in {wall:.3f} s: {tokens / wall:.2f} tokens/s; "
          f"{decode.calls} decode steps; peak device memory {peak / 2**30:.3f} GiB; "
          f"ssd_scan launches {launches}")
    for (prov, name), st in sorted(tally.device_apis.items()):
        if name.startswith("prefill[") or name.startswith("decode_step["):
            print(f"[serve] traced {name}: {st.calls} call(s), avg {st.avg_ns / 1e6:.3f} ms (first call per length included)")
    # warm step times outside the trace: host time to enqueue the step vs
    # time to its completion (equal when the host, not the card, bounds it)
    for S in sorted(set(PROMPT_LENS)):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, S)), device=DEVICE)
        host, done_ms = host_vs_device(lambda: model.prefill(params, {"tokens": toks}, 2048))
        print(f"[serve] prefill S={S}: {done_ms:.2f} ms to completion, host enqueue {host:.2f} ms (median of 5, warm)")
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.long, device=DEVICE)
    host, done_ms = host_vs_device(lambda: model.decode_step(params, eng.cache, {"token": tok}))
    print(f"[serve] decode step ({eng.cfg.batch_slots} slots): {done_ms:.2f} ms to completion, "
          f"host enqueue {host:.2f} ms (median of 5, warm)")
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
    return {"ssd_scan": launches}


# ---------------------------------------------------------------------------
# 5. the full-mode polling fence, and the command-line entry point
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
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import serve

    n, layers = 4, 48
    trace_dir = tempfile.mkdtemp(prefix="thapi_launch_")
    try:
        ssd_scan.launches = 0
        rc = serve.main(
            ["--arch", "mamba2-1.3b", "--full", "--trace", "default", "--trace-dir", trace_dir,
             "--requests", str(n), "--prompt-len", "512", "--new-tokens", "8"]
        )
        launches = ssd_scan.launches
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if rc != 0 or launches != layers * n:
        raise AssertionError(f"launcher rc={rc}, ssd_scan launches {launches} != {layers} x {n}")
    print(f"[launch] repro_torch.launch.serve --full --trace default: rc 0, ssd_scan launches {launches}")


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
    kernels = [check_ssd()]
    check_model_against_cpu()
    launches = serve_full_width()
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
