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
     calls per API;
  7. live: full-width h2o-danube-1.8b (8 requests of 100 to 4096 tokens, 16
     new tokens each, 4 slots, cache_len 4096) serves under a full-mode
     session with device sampling whose in-process master forwards to an
     upstream ``iprof serve`` in its own process; a stream-cadence policy
     ticks in the tracer, an advisory policy between the decode graph's
     replays.  After 8 decode steps: the engine's live profile has prefill
     and decode rows, ``iprof top --by-rank`` in its own process shows
     this rank on the upstream master, and the streamed telemetry's device
     memory is non-zero.  At stop the upstream composite equals the offline
     tally and the in-process master's final composite per API in (calls,
     total_ns); flash_attention ran 24 x prefills; the decode graph was
     captured once (replays = steps - 1); the tokens equal an untraced
     session's.  Then tokens/s and the warm replay, live against a
     default-mode trace without the live service, in turns (live, plain,
     live, plain), with the consumer thread's CPU share;
  8. the remaining serving families, each model released before the next
     loads: the flash kernel at their prefill shapes (moonshot's MHA at
     d=128, S = 1024 and 4096; whisper's non-causal encoder at S=T=1500 and
     its cross attention at S=448, T=1500; llava's 56 query and 8 KV heads
     at d=128, B=2, S=3008) in fp32 and bf16 against its plain version,
     timed beside its bound and scaled_dot_product_attention; two-layer
     full-width fp32 models on the card against the CPU (moonshot layer by
     layer with every layer's top-k expert sets compared, a near tie
     counted and the CPU's layer input fed to both sides after it; whisper
     with two encoder and two decoder layers over 1500 random frames; llava
     with 576 patch embeddings); full-width moonshot-v1-16b-a3b (48 layers,
     bf16) and whisper-medium (24 + 24 layers) served under a trace as the
     others are (flash 48 and 72 x prefills, none in decode), with their
     [graph] phase, warm step times and profiles (moonshot's 4096-token
     prefill: the flash and copy shares; whisper: the encoder's share of a
     prefill); full-width llava-next-34b through Model.prefill /
     decode_step (B=2, 2880 patch embeddings + 128 tokens, cache_len 4096,
     flash 60 x the prefill, 16 decode steps through decode_artifacts
     against the eager step); and the launcher at full width for moonshot
     and whisper;
  9. [train]: a two-layer full-width fp32 h2o-danube-1.8b train step on the
     card against the CPU (loss, gradient norm, every gradient, and the
     AdamW update from the CPU's gradients); full-width h2o-danube-1.8b
     (24 layers, bf16 weights, fp32 moments, 18.3 GB of state) trained
     through ``Trainer`` for 8 steps of 4 x 1024 ``SyntheticPipeline``
     tokens under a default-mode trace, with no kernel in the step (the
     JAX package trains through its plain attention), a checkpoint every 4
     steps and a failure injected at the 6th step call (restore and
     replay): finite losses, the last two below the first on average, the
     tally's framework rows; the warm step time, tokens/s, MFU, peak
     memory and a profiled step's shares printed; then the step-8
     checkpoint restored from disk (bit for bit the trained weights) into
     ``ServeEngine`` for prompts of 100, 512, 1024 and 512 tokens, 8 new
     tokens each, the flash kernel 24 x the prefills;
 10. [remediation]: full-width h2o-danube-1.8b trained as in [train] (no
     periodic checkpoint, no failure) under a default-mode trace on the
     sampled rung whose remediation engine, ticked by the tracer's consumer
     thread, escalates the rung to full, asks the trainer to drain and then
     replaces it as a driver thread flags the rank step after step: the
     drain checkpoint is written at step k on the loop's own thread, the
     trainer freed, a new one built, admit_replacement restores step k and
     the replacement runs to the end.  Gates: the decisions escalate,
     drain, replace (then the admission) each one ust_repro:remediation
     record, the rung change and every later step in the trace, the losses
     equal [train]'s, the save and restore times printed.  Then
     ``python -m repro_torch.examples.distributed_train`` on the card in
     its own process for each mode: --chaos with a slowdown (ladder to
     eviction), --chaos --chaos-replace with a kill (a replacement, the
     zombie fenced), --live with a slow rank, and the default mode (200
     steps, the loss falls, validation clean), each with its wall time;
 11. [train-moe-audio], run between 9 and 10: two-layer full-width fp32
     train steps on the card against the CPU as in [train], for
     moonshot-v1-16b-a3b (1 x 128 tokens; each layer's top-k expert sets
     compared first, a flipped near tie printed and the step then not
     gated) and whisper-medium (2 encoder + 2 decoder layers, 1500 random
     frames); full-width whisper-medium (24 + 24 layers, bf16 weights,
     fp32 moments) trained through ``Trainer`` under a default-mode trace,
     6 steps of 4 x 448 tokens over 1500 frames a row, checkpoints at steps
     4 and 6, then its step-4 checkpoint restored (bit for bit the weights
     after step 4) and served (prompts of 32, 256 and 448 tokens, flash 72 x
     the prefills); full-width moonshot at 4 of its 48 layers (its whole
     training state does not fit the card) trained 6 steps of 2 x 1024
     tokens under a trace, no checkpoint, each step's load-balance term
     finite and in (0, E], printed with the routing's spread, then served
     from memory (flash 4 x the prefills).  Gates: finite losses whose last two average below the
     first, no kernel launch in any train step, the framework rows; it
     prints the warm step, tokens/s, MFU (moonshot's also by the work its
     all-expert layer executes), peak memory and a profiled step's parts.
 12. [dryrun], after 10: ``python -m repro_torch.launch.dryrun --arch all``
     in its own process on meta tensors (its table and time; every cell
     runs but the mamba2-1.3b and recurrentgemma-2b train cells, refused
     naming ROADMAP section 4); full-width h2o-danube-1.8b's train step at
     4 x 1024 tokens under remat none, dots and full, each on fresh weights
     and released before the next: the dry run's peak within 10 % of the
     card's, its bound (the larger of compute and memory time) at or under
     the warm step, dots' and full's first loss and gradient norm within
     1e-2 of none's, the peaks of the loss and gradients ordered none >=
     dots >= full, roofline_fraction, useful_flops_ratio and MFU printed;
     then the danube (24 flash launches) and Mamba2-1.3B (48 SSD launches)
     prefills of 4096 tokens through the kernels, held the same way against
     the profiled busy time, their launches added to the kernels line.
     Every phase prints its seconds, and the run ends with all of them.
The reduced-depth fp32 models of phases 2-4, 8, 9 and 11 are held to the CPU by
``_rel`` (max|card - cpu| / max|cpu|) under ``CPU_REL_LIMIT``.
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

import contextlib
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

#: published H100 SXM fp32 peak outside the tensor cores (NVIDIA data sheet);
#: the bf16 peak and the HBM rate are the card's row in repro_torch.launch.roofline
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
#: limits on ``_rel`` (max|card - cpu| / max|cpu|, each output, cache leaf,
#: gradient or updated weight) of the reduced-depth fp32 models on the card
#: against the CPU, by tag: about ten times the largest reading of slice
#: 10's runs on an H100 (model 1.9e-6, model-rg 3.8e-6, model-dn 3.7e-6,
#: model-moe 2.7e-6, model-ed 1.7e-6, model-vlm 9.7e-6, train 4.7e-6),
#: printed beside each; every limit times its outputs' max|cpu| is under
#: the 1e-3 of the ``allclose(rtol=1e-3, atol=1e-3)`` they replace
CPU_REL_LIMIT = {"model": 2e-5, "model-rg": 4e-5, "model-dn": 4e-5, "model-moe": 3e-5, "model-ed": 2e-5,
                 "model-vlm": 1e-4, "train": 5e-5, "train-moe": 5e-5, "train-ed": 5e-5}


def _card():
    """The card's published figures, its row in ``repro_torch.launch.roofline``
    by its name (an unknown card raises)."""
    import torch

    from repro_torch.launch import roofline

    return roofline.card(torch.cuda.get_device_name(0))


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


def library_device_ms(lib, reps: int = 5) -> tuple:
    """(device ms per call, the two longest device operations as (name, ms
    per launch)) of the library call ``lib``: every device operation it runs,
    each at its mean time per launch times its launches per call, from
    ``device_kernels``; None when the profiler recorded none (not measured).
    The kernel's own device time is read the same way, so the two compare
    device time with device time."""
    ran = device_kernels(lib, reps=reps)
    if not ran:
        return None, []
    total = sum(ms * max(1, round(n / reps)) for ms, n in ran.values())
    return total, [(name, ms) for name, (ms, _) in sorted(ran.items(), key=lambda kv: -kv[1][0])[:2]]


def _lib_dev_text(lib_dev, dev: float, ran: list) -> str:
    """The library call's device time beside the kernel's, for a print."""
    if lib_dev is None:
        return "no device operation recorded (library device time not measured)"
    return (f"{lib_dev:.4f} ms per call on the device (profiler), the kernel's device time {dev / lib_dev:.2f}x "
            "that; longest: " + "; ".join(f"{t:.4f} {name[:100]}" for name, t in ran))


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
    peak = _card().peak_flops if el == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / _card().hbm_bw, flops / peak
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
    t_bytes = rglru_bytes(x, h0) / _card().hbm_bw
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
            f"{rglru_bytes(x, h0) / (dev * 1e-3) / 1e12:.3f} TB/s of the card's {_card().hbm_bw / 1e12:.2f}, "
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
    peak = _card().peak_flops if el == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / _card().hbm_bw, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, window, causal: bool = True):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (heads moved to dim 1 as views).  Its is_causal aligns the
    mask top-left, the kernel bottom-right: the same at S = T, which is all
    it is timed at under causal.  Where the window bites (some query sits
    window or more past a key) it gets the kept set as a boolean mask
    instead."""
    import torch
    import torch.nn.functional as F

    S, T = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None or S <= window:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
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
    rows, shapes = {}, []
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
        lib_dev, ran = library_device_ms(lib)
        rows[S] = (ms, dev, plain, library, lib_dev, bound, by)
        shapes.append({"shape": f"danube: B=1 S={S} T={S} H=32 Kv=8 d=80 causal=True window=4096", "ms": ms,
                       "device_ms": dev, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                       "library_ms": library, "library_device_ms": lib_dev})
        print(
            f"[flash-time] bf16 B=1 S={S} H=32 Kv=8 d=80 window 4096: kernel {ms:.4f} ms per call (CUDA events), "
            f"{dev:.4f} ms on the device (profiler), plain {plain:.4f} ms, "
            f"library scaled_dot_product_attention {library:.4f} ms (max|d| vs kernel {lib_err:.3g}), "
            f"bound {bound:.5f} ms ({by}; {flash_pairs(S, S, True, 4096)} kept pairs per head)"
        )
        print(f"[flash-time] library S={S}: {_lib_dev_text(lib_dev, dev, ran)}")
    ms, dev, plain, library, lib_dev, bound, by = rows[FLASH_TIME_S[1]]
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
        "library_device_ms": lib_dev,
        "hgmma": sum(hgmma.values()) if hgmma else "not measured",
        "shapes": shapes,  # each timed shape; the later families' are added after their [flash] phase
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
        rel = _within("model", name, a, b)
        print(f"[model] 2-layer full-width fp32, 512-token prompt, {name}: card vs cpu max|d|="
              f"{(a - b).abs().max().item():.3g}, max|d|/max|cpu| {rel:.3g} (limit {CPU_REL_LIMIT['model']:g}) ok")


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
    worst, rels = 0.0, []
    for name, a, b in zip(names, out[DEVICE], out["cpu"]):
        rels.append(f"{name} {_within('model-rg', name, a, b):.3g}")
        worst = max(worst, (a - b).abs().max().item())
    print(f"[model-rg] 5-layer full-width fp32, 300-token prompt, cache_len 256: logits of prefill and "
          f"2 decode steps and {len(names) - 3} cache leaves, card vs cpu max|d|={worst:.3g}; max|d|/max|cpu| "
          f"(limit {CPU_REL_LIMIT['model-rg']:g}): {'; '.join(rels)} ok")


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
        rel = _within("model-dn", f"{name} at S={S}", a, b)
        errs.append(f"{name} {(a - b).abs().max().item():.3g} (|x| up to {b.abs().max().item():.3g}; "
                    f"relative {rel:.3g})")
    print(f"[model-dn] 2-layer full-width fp32, {S}-token prompt, cache_len {cache_len} (rolled ring), card vs cpu "
          f"max|d| (relative limit {CPU_REL_LIMIT['model-dn']:g}): {'; '.join(errs)} ok")


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

    from repro_torch.serve.engine import prompt_batch

    for S in sorted(set(prompt_lens)):
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, S)), device=DEVICE)
        host, done_ms = host_vs_device(lambda: model.prefill(params, prompt_batch(model, toks), cache_len))
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
          f"{_numel(params)} parameters (config formula: num_params {cfg.num_params()}, active_params "
          f"{cfg.active_params()}), {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
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


#: elements of ``_rel``'s float64 blocks (128 MiB each)
REL_BLOCK = 1 << 24


def _rel(a, b) -> float:
    """max|a - b| / max|b| in float64 on ``a``'s device, ``REL_BLOCK``
    elements at a time (``b``'s block moved there): a full-width leaf in
    float64 does not fit beside moonshot's weights, and on the host the
    float64 passes over a two-layer moonshot's gradients and weights took
    a minute."""
    if a.shape != b.shape:
        raise ValueError(f"_rel of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    num = den = 0.0
    for x, y in zip(a.flatten().split(REL_BLOCK), b.flatten().split(REL_BLOCK), strict=True):
        y = y.to(x.device).double()
        num = max(num, float((x.double() - y).abs().max()))
        den = max(den, float(y.abs().max()))
    return num / max(den, 1e-30)


def _within(tag: str, name: str, a, b) -> float:
    """``_rel(a, b)`` of a card result ``a`` and its CPU twin ``b``, on the
    card; fails on a non-finite ``a`` or past ``CPU_REL_LIMIT[tag]``."""
    import torch

    if a.is_floating_point() and not torch.isfinite(a).all():
        raise AssertionError(f"[{tag}] non-finite {name} on the card")
    rel = _rel(a, b)
    if not rel <= CPU_REL_LIMIT[tag]:
        raise AssertionError(f"[{tag}] card and CPU disagree on {name}: max|d|/max|cpu| = {rel:.3g} > "
                             f"{CPU_REL_LIMIT[tag]:g}")
    return rel


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
    from repro_torch.serve.engine import prompt_batch

    V = model.cfg.vocab_size
    long_toks = torch.as_tensor(rng.integers(0, V, size=(1, long_prompt)), device=DEVICE)

    def prefill_peak() -> float:
        """MiB that a warm ``long_prompt`` prefill adds at its peak to what is allocated."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.prefill(params, prompt_batch(model, long_toks), cache_len)
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
# live: traced serving that streams to a local and an upstream master
# ---------------------------------------------------------------------------

#: the [live] phase's requests: full-width h2o-danube-1.8b, 4 slots
LIVE_PROMPT_LENS = (100, 512, 1024, 4096, 256, 512, 100, 1024)
LIVE_CACHE_LEN = 4096
LIVE_MID_STEPS = 8  # decode steps before the mid-session readings
LIVE_SUBPROCESS_S = 240  # each iprof subprocess's own time limit
LIVE_WAIT_S = 30.0  # each wait for the masters to catch up


def _wait(pred, what: str, timeout_s: float = LIVE_WAIT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"[live] {what}: not reached in {timeout_s} s")
        time.sleep(0.02)


def _iprof_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def _start_upstream_master():
    """``iprof serve --port 0`` in its own process; (process, its address)
    once it prints where it listens."""
    import select

    cmd = [sys.executable, "-m", "repro_torch.core.iprof", "serve", "--port", "0", "--duration",
           str(4 * LIVE_SUBPROCESS_S)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=_iprof_env(), cwd=ROOT)
    deadline = time.monotonic() + LIVE_SUBPROCESS_S
    seen = []
    while time.monotonic() < deadline and proc.poll() is None:
        if not select.select([proc.stdout], [], [], 1.0)[0]:
            continue
        line = proc.stdout.readline()
        seen.append(line)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            print(f"[live] upstream master: {line.strip()}")
            return proc, f"127.0.0.1:{m.group(1)}"
    proc.kill()
    proc.wait(timeout=30)
    raise AssertionError(f"[live] iprof serve did not start (rc {proc.returncode}): {''.join(seen)[-2000:]}")


def _stop_upstream_master(proc) -> str:
    """Interrupt ``iprof serve`` as a user's ^C does; its stop line."""
    import signal

    proc.send_signal(signal.SIGINT)
    out, _ = proc.communicate(timeout=LIVE_SUBPROCESS_S)
    stop = [line for line in out.splitlines() if "master stopped" in line]
    if proc.returncode != 0 or not stop:
        raise AssertionError(f"[live] iprof serve exited {proc.returncode}: {out[-2000:]}")
    return stop[0].strip()


def _thread_cpu_s(thread) -> float:
    """CPU seconds (user + system) a thread of this process has run."""
    with open(f"/proc/self/task/{thread.native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _decode_calls(t) -> int:
    st = None if t is None else t.apis.get(("ust_repro", "decode_step"))
    return 0 if st is None else st.calls


def _totals(t) -> dict:
    return {**{k: (s.calls, s.total_ns) for k, s in t.apis.items()},
            **{("device",) + k: (s.calls, s.total_ns) for k, s in t.device_apis.items()}}


def _live_config(out_dir: str, upstream: str):
    from repro_torch.core import StreamCadencePolicy, TraceConfig

    # the cadence policy turns no fidelity knob, so the live composite
    # stays the offline tally exactly
    return TraceConfig(out_dir=out_dir, mode="full", sample=True, serve_port=0, stream_to=upstream,
                       adaptive=[StreamCadencePolicy("ust_repro", "decode_step", fast_s=0.1, slow_s=0.5)])


def _live_engine(model, params, prompts):
    from repro_torch.core import AdaptiveController, ThresholdAdvisoryPolicy
    from repro_torch.serve import ServeConfig, ServeEngine

    # an advisory policy, ticked between the decode graph's replays (period
    # 0: every step); it narrates and turns no knob
    ctrl = AdaptiveController([ThresholdAdvisoryPolicy("ust_repro", "prefill", high=0.5, low=0.1)],
                              period_s=0.0)
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=LIVE_CACHE_LEN,
                                                 max_new_tokens=NEW_TOKENS), adaptive=ctrl)
    reqs = [eng.submit(p) for p in prompts]
    return eng, reqs, ctrl


def _replay_ms(eng) -> tuple:
    """(ms to completion, host enqueue ms) of a warm replay of the engine's
    decode graph, medians of 5."""
    batch = {"token": eng._tok}
    host, done_ms = host_vs_device(lambda: eng.decode_fn(eng.params, eng.cache, batch))
    return done_ms, host


def _timed_session(model, params, prompts, upstream: str, live: bool) -> tuple:
    """One session for the tokens/s readings: the live configuration, or a
    default-mode trace without the live service; (tokens/s, replay ms,
    replay host ms, the consumer thread's CPU share of the wall time, the
    traced prefill and decode_step spans' total ms)."""
    import torch

    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import tally_trace

    eng, reqs, _ = _live_engine(model, params, prompts)
    d = tempfile.mkdtemp(prefix="thapi_live_")
    try:
        cfg = _live_config(d, upstream) if live else TraceConfig(out_dir=d, mode="default")
        torch.cuda.synchronize()
        with Tracer(cfg) as tr:
            cpu0 = _thread_cpu_s(tr._consumer)
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            share = (_thread_cpu_s(tr._consumer) - cpu0) / wall
            done_ms, host = _replay_ms(eng)
        spans = tally_trace(d).apis
    finally:
        shutil.rmtree(d, ignore_errors=True)
    span_ms = {api: spans[("ust_repro", api)].total_ns / 1e6 for api in ("prefill", "decode_step")}
    return sum(len(r.out_tokens) for r in reqs) / wall, done_ms, host, share, span_ms


def live_phase() -> None:
    """Full-width h2o-danube-1.8b serves under live tracing: the session's
    in-process master forwards to an upstream master (``iprof serve`` in
    its own process); one adaptive policy ticks in the tracer, one between
    the engine's decode-graph replays.  Mid-session: the engine's live
    profile, ``iprof top --by-rank`` on the upstream master in its own
    process, and the streamed device memory.  At stop: the upstream
    composite equals the offline tally and the in-process master's final
    composite per API in (calls, total_ns); flash_attention ran 24 x
    prefills; the decode graph was captured once; the tokens equal an
    untraced session's.  Then tokens/s and the replay's time, live against
    a default-mode trace without the live service, in turns."""
    import numpy as np
    import torch

    from repro_torch.core import StreamClient, Tracer
    from repro_torch.core.plugins.tally import tally_trace
    from repro_torch.serve.artifacts import DecodeGraph

    t_phase = time.perf_counter()
    model, params = init_full_width("h2o-danube-1.8b", "live")
    L = model.cfg.num_layers
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=(S,)) for S in LIVE_PROMPT_LENS]
    n = len(prompts)
    card = card_line()
    upstream_proc, upstream = _start_upstream_master()
    root = tempfile.mkdtemp(prefix="thapi_live_")
    try:
        # the untraced session first: its tokens are the reference
        plain, plain_reqs, _ = _live_engine(model, params, prompts)
        plain.run_until_drained()
        plain_tokens = [r.out_tokens for r in plain_reqs]
        del plain, plain_reqs  # its cache and graph: the telemetry below reads the live engine's alone

        out = os.path.join(root, "trace")
        eng, reqs, ctrl = _live_engine(model, params, prompts)
        if not isinstance(eng.decode_fn, DecodeGraph):
            raise AssertionError(f"[live] the engine's decode step is {eng.decode_fn!r}, not a DecodeGraph")
        torch.cuda.synchronize()
        reset_launches()
        steps = 0
        with Tracer(_live_config(out, upstream)) as tr:
            print(f"[live] session master on {tr.server.addr}, forwarding to {upstream}")
            while eng.step():
                steps += 1
                if steps != LIVE_MID_STEPS:
                    continue
                _wait(lambda: _decode_calls(eng.live_tally()) == steps, f"the live tally with {steps} decode steps")
                live = eng.live_tally()
                profile = eng.live_profile(top=5)
                names = {a for _, a in live.device_apis}
                if not profile or not any(a.startswith("prefill[") for a in names) or not any(
                        a.startswith("decode_step[") for a in names):
                    raise AssertionError(f"[live] mid-session live profile: {profile!r}, device rows {names}")
                print(f"[live] mid-session, after {steps} decode steps, the engine's live_profile(top=5):")
                print(profile)
                print(f"[live] mid-session device rows: {sorted(names)}")
                src = tr._stream_source
                with StreamClient(upstream) as c:
                    _wait(lambda: src in c.ranks()[0], f"the upstream master to hold {src}")
                t0 = time.perf_counter()
                top = subprocess.run([sys.executable, "-m", "repro_torch.core.iprof", "top", upstream,
                                      "--iterations", "1", "--no-clear", "--by-rank"], capture_output=True,
                                     text=True, timeout=LIVE_SUBPROCESS_S, env=_iprof_env(), cwd=ROOT)
                print(top.stdout, end="")
                if top.returncode != 0 or src not in top.stdout:
                    raise AssertionError(f"[live] iprof top exited {top.returncode} without {src}'s row: "
                                         f"{top.stderr[-2000:]}")
                print(f"[live] iprof top --by-rank on {upstream}: rc 0, {src}'s row shown "
                      f"({time.perf_counter() - t0:.1f} s in its own process)")
                (telem,) = tr.server.telemetry().values()
                alloc = torch.cuda.memory_allocated()
                with StreamClient(upstream) as c:
                    wire = c.ranks()[1].get("telemetry", {}).get(src, {})
                if not all(t.get("mem_in_use", 0) > 0 and t.get("mem_limit", 0) > 0 for t in (telem, wire)):
                    raise AssertionError(f"[live] streamed telemetry without device memory: {telem}, upstream {wire}")
                print(f"[live] streamed telemetry: mem_in_use {telem['mem_in_use']} B, mem_peak "
                      f"{telem['mem_peak']} B, mem_limit {telem['mem_limit']} B, host_rss {telem['host_rss']} B; "
                      f"torch.cuda.memory_allocated() {alloc} B at the same moment (the sample is at most "
                      f"{tr.cfg.sample_period_s} s old); at the upstream master, one forward older: mem_in_use "
                      f"{wire['mem_in_use']} B; {card}")
            torch.cuda.synchronize()
        launches = read_launches()
        final = tr.server.composite()
        offline = tally_trace(out)
        with StreamClient(upstream) as c:
            _wait(lambda: _totals(c.composite()[0]) == _totals(offline),
                  "the upstream composite to equal the offline tally")
            upstream_t, meta = c.composite()
        tokens = [r.out_tokens for r in reqs]
        g = eng.decode_fn
        prefills = offline.apis[("ust_repro", "prefill")].calls
        checks = {
            "upstream composite == offline tally": _totals(upstream_t) == _totals(offline),
            "in-process master's final composite == offline tally": _totals(final) == _totals(offline),
            f"flash_attention launches == {L} x {prefills} prefills":
                launches == {"ssd_scan": 0, "rglru_scan": 0, "flash_attention": L * prefills} and prefills == n,
            f"decode graph: one capture, {g.replays} replays == {steps} steps - 1": g.replays == steps - 1,
            "engine ticks == steps - 1": ctrl.ticks == steps - 1,
            "tokens == the untraced session's": tokens == plain_tokens,
            "every request got its tokens": all(len(t) == NEW_TOKENS for t in tokens),
        }
        for what, ok in checks.items():
            print(f"[live] {what}: {'ok' if ok else 'FAILED'}")
        print(f"[live] {len(offline.apis) + len(offline.device_apis)} rows, "
              f"{sum(s.calls for s in offline.apis.values())} host calls; upstream holds {meta['sources']} "
              f"source(s); launches {launches}{launch_detail()}")
        if not all(checks.values()):
            raise AssertionError("[live] a gate above failed")
        st = tr.server.stats()
        fwd = tr.server.forwarder
        print(f"[live] in-process master: {st['snapshots']} snapshots ({st['deltas']} deltas, "
              f"{st['resyncs']} resyncs); its forwarder pushed {fwd.pushed} frames ({fwd.full_frames} full, "
              f"{fwd.delta_frames} delta), {fwd.bytes_sent} bytes, dropped {fwd.dropped}; the session handle "
              f"streamed={tr.handle.streamed} stream_dropped={tr.handle.stream_dropped}; {card}")
        for a in tr.adaptive.actions:
            print(f"[live] tracer controller: {a}")
        for a in ctrl.actions:
            print(f"[live] engine controller: {a}")
        print(f"[live] knob turns: tracer {len(tr.adaptive.actions)} in {tr.adaptive.ticks} windows, engine "
              f"{len(ctrl.actions)} in {ctrl.ticks} ticks; {card}")

        # tokens/s and the warm replay, live against a default-mode trace
        # without the live service, in turns
        for live in (True, False, True, False):
            tps, done_ms, host, share, span_ms = _timed_session(model, params, prompts, upstream, live)
            what = "live (full, sample, both masters, adaptive)" if live else "default, no live service"
            print(f"[live] session {what}: {tps:.2f} tokens/s; the {n} prefill spans {span_ms['prefill']:.1f} ms, "
                  f"the decode_step spans {span_ms['decode_step']:.1f} ms in all; warm decode replay "
                  f"{done_ms:.3f} ms to completion, host enqueue {host:.3f} ms (median of 5, inside the "
                  f"session); consumer thread CPU {share:.3f} of the wall time; {card}")
        print(f"[live] upstream {_stop_upstream_master(upstream_proc)}; {card}")
        print(f"[live] phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if upstream_proc.poll() is None:  # a gate failed before the master's stop
            upstream_proc.kill()
            upstream_proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# The remaining serving families: MoE, encoder-decoder and the VLM prefix
# ---------------------------------------------------------------------------

MOONSHOT = "moonshot-v1-16b-a3b"
WHISPER = "whisper-medium"
LLAVA = "llava-next-34b"
#: the flash kernel at the new families' prefill shapes (name, B, S, T, H,
#: Kv, d, causal): moonshot's MHA at d=128; whisper's non-causal encoder at
#: T=1500 (no multiple of the 64-key tile) and its cross attention with S <
#: T; llava's 7 query heads a KV head over 2880 patches and 128 tokens
FLASH_FAMILY_CASES = [
    ("moonshot", 1, 1024, 1024, 16, 16, 128, True),
    ("moonshot", 1, 4096, 4096, 16, 16, 128, True),
    ("whisper encoder", 1, 1500, 1500, 16, 16, 64, False),
    ("whisper cross", 1, 448, 1500, 16, 16, 64, False),
    ("llava", 2, 3008, 3008, 56, 8, 128, True),
]
#: the two-layer moonshot card-against-CPU prompt, and its router's near tie:
#: a token whose top-k sets differ fails unless the CPU's gap between its
#: k-th and (k+1)-th probability is under this
MOE_CPU_PROMPT = 512
NEAR_TIE = 1e-5
#: whisper's two-plus-two-layer prompt (its real decoder length) and cache_len
WHISPER_CPU_CASE = (448, 512)
#: llava's two-layer card-against-CPU run: one 24x24 tile of patches, text, cache_len
VLM_CPU_CASE = (576, 64, 1024)
MOE_PROMPT_LENS = (100, 512, 1024, 2000, 256, 512)
MOE_LONG_PROMPT = 4096
WHISPER_PROMPT_LENS = (32, 128, 448, 1024, 64, 256)
#: whisper prompts whose warm prefill the encoder's time is set against; the
#: last is also the [graph] phase's long prompt and the profiled prefill
WHISPER_SHARE_LENS = (32, 448, 1024)
#: the [vlm] phase: batch rows, text tokens, cache_len and decode steps
VLM_BATCH, VLM_TEXT, VLM_CACHE_LEN, VLM_STEPS = 2, 128, 4096, 16


def release(tag: str) -> None:
    """Free what the last phase left on the card before the next model loads."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[release] {tag}: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")


def check_flash_families() -> tuple:
    """The flash kernel at FLASH_FAMILY_CASES against its plain version in
    fp32 (1e-4) and bf16 (2e-3 + 2e-2·max|o_ref| of the row), then timed in
    bf16 beside its bound and scaled_dot_product_attention.  Returns (max
    |do|, a row per shape for the kernels line)."""
    import torch

    from repro_torch.kernels import flash_attention, ref

    max_err, rows = 0.0, []
    for i, (name, B, S, T, H, Kv, d, causal) in enumerate(FLASH_FAMILY_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(B, S, T, H, Kv, d, dtype, seed=200 + i)
            o = flash_attention.flash_attention(q, k, v, causal=causal)
            o_ref = ref.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            close, limit = flash_close(o, o_ref, dtype, True)
            ok = o.dtype == dtype and bool(torch.isfinite(o).all()) and close
            print(f"[flash] {name}: {dtype} B={B} S={S} T={T} H={H} Kv={Kv} d={d} causal={causal}: "
                  f"max|do|={err:.3g} tol {limit} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"flash_attention disagrees with flash_attention_ref at {name} {dtype}")
            max_err = max(max_err, err)
            del o_ref
        call = lambda: flash_attention.flash_attention(q, k, v, causal=causal)  # noqa: E731
        ms = cuda_ms(call)
        dev = kernel_device_ms(call, ("flash_attention_wgmma_kernel",))["flash_attention_wgmma_kernel"]
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), reps=5)
        lib = sdpa_call(q, k, v, None, causal)
        lib_err = (lib().transpose(1, 2).float() - call().float()).abs().max().item()
        if lib_err > 2e-2:
            raise AssertionError(f"the library yardstick computes another function at {name}: max|d|={lib_err:.3g}")
        library = cuda_ms(lib)
        lib_dev, ran = library_device_ms(lib)
        bound, by = flash_bound(q, k, causal, None)
        shape = f"{name}: B={B} S={S} T={T} H={H} Kv={Kv} d={d} causal={causal}"
        print(f"[flash-time] bf16 {shape}: kernel {ms:.4f} ms per call (CUDA events), {dev:.4f} ms on the device "
              f"(profiler), plain {plain:.4f} ms, library scaled_dot_product_attention {library:.4f} ms per call "
              f"(CUDA events; max|d| vs kernel {lib_err:.3g}), bound {bound:.5f} ms ({by}); device {dev / bound:.2f}x "
              f"the bound; events {ms / library:.2f}x the library's")
        print(f"[flash-time] library {name}: {_lib_dev_text(lib_dev, dev, ran)}")
        rows.append({"shape": shape, "ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": library, "library_device_ms": lib_dev})
        del q, k, v
    return max_err, rows


def _routing(cfg, pl, h) -> tuple:
    """(top-k expert ids, fp32 router probabilities) of the router input ``h``."""
    import torch

    from repro_torch.models import moe

    xt = h.reshape(-1, cfg.d_model)
    return moe._router(cfg, pl["router"], xt)[1], torch.softmax(xt.float() @ pl["router"].float(), dim=-1)


def _near_ties(cfg, ids, ids_cpu, probs_cpu, where: str) -> list:
    """The tokens whose top-k expert sets differ between the card and the
    CPU; each must be a near tie (the CPU's gap between its k-th and
    (k+1)-th probability under NEAR_TIE), else the phase fails."""
    k = cfg.moe.top_k
    differ = (ids.sort(dim=-1).values.cpu() != ids_cpu.sort(dim=-1).values).any(dim=-1).nonzero().flatten().tolist()
    top = probs_cpu.topk(k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    far = [(t, gap[t].item()) for t in differ if gap[t] >= NEAR_TIE]
    if far:
        raise AssertionError(f"[model-moe] {where}: tokens {far} chose other experts on the card, (token, gap)")
    return differ


def _close_rows(tag: str, name: str, a, b, skip=()) -> float:
    """``_within(tag, ...)`` over the rows (dim 1 of [B, S, ...], or dim 0 of
    a [B, 1, ...] decode) not in ``skip``: max|a - b| / max|b|."""
    import torch

    a, b = a.float().cpu(), b.float().cpu()
    if skip:
        keep = torch.ones(a.shape[1] if a.shape[1] > 1 else a.shape[0], dtype=torch.bool)
        keep[list(skip)] = False
        a, b = (a[:, keep], b[:, keep]) if a.shape[1] > 1 else (a[keep], b[keep])
    return _within(tag, name, a, b)


def check_moe_against_cpu() -> None:
    """Two full-width moonshot-v1-16b-a3b layers, fp32: a MOE_CPU_PROMPT-token
    prompt and three decode steps, card (flash kernel) against CPU (plain),
    layer by layer.  Each layer's top-k expert set per token must agree; a
    token whose sets differ is a near tie (else the phase fails), is left out
    of that layer's comparison, and from the next layer on both devices take
    the CPU's layer input.  Layer outputs, cache rows and logits within
    ``CPU_REL_LIMIT["model-moe"]`` of max|cpu|;
    both devices decode the CPU's greedy token."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe, transformer
    from repro_torch.models.layers import apply_norm, embed, layer_slice, prefill_rows, unembed

    cfg = dataclasses.replace(get_config(MOONSHOT), num_layers=2, dtype="float32")
    params = Model(cfg).init(torch.Generator(device=DEVICE).manual_seed(4))
    devs = {"card": (DEVICE, params), "cpu": ("cpu", _to(params, "cpu"))}
    S, V, cache_len = MOE_CPU_PROMPT, cfg.vocab_size, MOE_CPU_PROMPT + 4
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, V, size=(1, S)))
    ties, worst, cpu_s = 0, 0.0, 0.0

    def layer(where: str, l: int, run) -> dict:
        """Layer l on both sides, ``run(side, pl, mlp) -> (x, *more)``;
        checks the routing and the outputs, and returns {side: (x, *more)}
        with the card's x the CPU's after a near tie."""
        nonlocal ties, worst, cpu_s
        out, route = {}, {}
        for side, (_, p) in devs.items():
            pl = layer_slice(p["blocks"], l)
            seen = []
            t0 = time.perf_counter()
            out[side] = run(side, pl, lambda c, pl_, h: seen.append(h) or moe._moe_mlp(c, pl_, h))
            route[side] = _routing(cfg, pl, seen[0])
            cpu_s += (time.perf_counter() - t0) if side == "cpu" else 0.0
        tied = _near_ties(cfg, route["card"][0], *route["cpu"], f"{where} layer {l}")
        ties += len(tied)
        for j, (a, b) in enumerate(zip(out["card"], out["cpu"], strict=True)):
            worst = max(worst, _close_rows("model-moe", f"{where} layer {l} output {j}", a, b, tied if j == 0 else ()))
        if tied:
            out["card"] = (out["cpu"][0].to(DEVICE),) + tuple(out["card"][1:])
        return out

    x = {side: embed(p["embed"], toks.to(dev)) for side, (dev, p) in devs.items()}
    cache = {side: {"k": [], "v": []} for side in devs}
    for l in range(cfg.num_layers):
        out = layer("prefill", l, lambda side, pl, mlp: transformer.prefill_layer(
            cfg, pl, x[side], torch.arange(S, device=devs[side][0])[None], mlp))
        for side, (xo, k, v) in out.items():
            x[side] = xo
            cache[side]["k"].append(prefill_rows(k, cache_len, False))
            cache[side]["v"].append(prefill_rows(v, cache_len, False))
    for side, c in cache.items():
        c.update(k=torch.stack(c["k"]), v=torch.stack(c["v"]),
                 len=torch.full((1,), S, dtype=torch.int32, device=devs[side][0]))
    for step in range(4):
        logits = {side: unembed(cfg, p["embed"], apply_norm(cfg, p["ln_f"], x[side][:, -1:]))
                  for side, (_, p) in devs.items()}
        worst = max(worst, _close_rows("model-moe", f"logits after {step} decode steps", logits["card"], logits["cpu"]))
        if step == 3:
            break
        tok = torch.argmax(logits["cpu"][:, 0, :V], dim=-1)
        if not torch.equal(torch.argmax(logits["card"][:, 0, :V], dim=-1).cpu(), tok):
            print(f"[model-moe] the greedy tokens before decode step {step + 1} differ; both sides decode the CPU's")
        x = {side: embed(p["embed"], tok.to(dev)[:, None]) for side, (dev, p) in devs.items()}
        valid = {side: torch.clamp(c["len"] + 1, max=cache_len) for side, c in cache.items()}
        for l in range(cfg.num_layers):
            out = layer(f"decode {step + 1}", l, lambda side, pl, mlp: (transformer.decode_layer(
                cfg, pl, x[side], cache[side]["k"][l], cache[side]["v"][l], cache[side]["len"], valid[side], mlp),))
            x = {side: o[0] for side, o in out.items()}
        for c in cache.values():
            c["len"] += 1
    for name in ("k", "v"):
        worst = max(worst, _close_rows("model-moe", f"cache {name}", cache["card"][name], cache["cpu"][name]))
    print(f"[model-moe] 2-layer full-width fp32, {S}-token prompt, cache_len {cache_len}, 3 decode steps: layer "
          f"outputs, logits and cache rows card vs cpu max|d|/max|cpu| {worst:.3g} (limit "
          f"{CPU_REL_LIMIT['model-moe']:g}); top-k expert sets equal "
          f"but for {ties} near tie(s) (CPU gap under {NEAR_TIE}); the CPU side took {cpu_s:.1f} s")


def check_family_against_cpu(cfg, tag: str, seed: int, batch_of, cache_len: int, what: str) -> None:
    """A reduced-depth full-width ``cfg`` (fp32): the prefill of
    ``batch_of(device)`` and three decode steps, card (flash kernel)
    against CPU (plain), over logits and every cache leaf, each within
    ``CPU_REL_LIMIT[tag]`` of max|cpu|."""
    import torch

    from repro_torch.models import Model

    model = Model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))
    out, cpu_s = {}, 0.0
    for dev, p in ((DEVICE, params), ("cpu", _to(params, "cpu"))):
        t0 = time.perf_counter()
        logits, cache = model.prefill(p, batch_of(dev), cache_len)
        steps = [logits]
        tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        for _ in range(3):
            logits, cache = model.decode_step(p, cache, {"token": tok})
            steps.append(logits)
            tok = torch.argmax(logits[:, 0, : cfg.vocab_size], -1)
        out[dev] = [t.float().cpu() for t in steps] + [t.float().cpu() for t in _leaves(cache)]
        if dev == "cpu":
            cpu_s = time.perf_counter() - t0
    names = ["prefill", "decode1", "decode2", "decode3"] + [f"cache {k}" for k in cache]
    errs = [f"{n} {_close_rows(tag, n, a, b):.3g}" for n, a, b in zip(names, out[DEVICE], out["cpu"], strict=True)]
    print(f"[{tag}] {what}, fp32, cache_len {cache_len}: card vs cpu max|d|/max|cpu| (limit {CPU_REL_LIMIT[tag]:g}): "
          f"{'; '.join(errs)} ok; "
          f"the CPU side took {cpu_s:.1f} s")


def check_whisper_against_cpu() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    base = get_config(WHISPER)
    cfg = dataclasses.replace(base, num_layers=2, dtype="float32",
                              encdec=dataclasses.replace(base.encdec, enc_layers=2))
    S, cache_len = WHISPER_CPU_CASE
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, S)))
    frames = torch.as_tensor(rng.normal(size=(1, cfg.encdec.enc_positions, cfg.d_model)).astype(np.float32))
    check_family_against_cpu(cfg, "model-ed", 5, lambda dev: {"tokens": toks.to(dev), "frames": frames.to(dev)},
                             cache_len, f"2 encoder + 2 decoder full-width layers, {cfg.encdec.enc_positions} "
                             f"random frames, {S}-token prompt")


def check_vlm_against_cpu() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LLAVA), num_layers=2, dtype="float32")
    P, S, cache_len = VLM_CPU_CASE
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, S)))
    patches = torch.as_tensor(rng.normal(0, 0.02, size=(1, P, cfg.d_model)).astype(np.float32))
    check_family_against_cpu(cfg, "model-vlm", 6,
                             lambda dev: {"tokens": toks.to(dev), "patch_embeds": patches.to(dev)}, cache_len,
                             f"2 full-width layers, {P} patch embeddings + {S}-token prompt")


def _flash_gate(tag: str, launches: dict, per_prefill: int, prefills: int, steps: int) -> int:
    if launches != {"ssd_scan": 0, "rglru_scan": 0, "flash_attention": per_prefill * prefills}:
        raise AssertionError(f"[{tag}] launches {launches}: want flash_attention = {per_prefill} x {prefills} "
                             "prefills, no other kernel")
    print(f"[{tag}] flash_attention launches {launches['flash_attention']} = {per_prefill} per prefill x "
          f"{prefills} prefills (none in the {steps} decode steps)")
    return launches["flash_attention"]


def _finite_cache(tag: str, cache) -> None:
    import torch

    if not all(bool(torch.isfinite(t.float()).all()) for t in _leaves(cache) if t.is_floating_point()):
        raise AssertionError(f"[{tag}] non-finite cache")


def serve_moonshot() -> int:
    """Full-width moonshot-v1-16b-a3b (48 layers, 64 experts, top-6, bf16):
    the traced session (flash in every layer of every prefill, none in
    decode), warm step times, the decode graph, and the profiles of a decode
    step and of a MOE_LONG_PROMPT prefill (the flash kernel's and the copy
    kernels' shares)."""
    import numpy as np
    import torch

    model, params = init_full_width(MOONSHOT, "moe")
    L = model.cfg.num_layers
    rng = np.random.default_rng(4)
    eng, _, launches, steps = traced_session(model, params, MOE_PROMPT_LENS, rng, "moe")
    _finite_cache("moe", eng.cache)
    n = _flash_gate("moe", launches, L, len(MOE_PROMPT_LENS), steps)
    warm_step_times(model, params, eng, MOE_PROMPT_LENS + (MOE_LONG_PROMPT,), rng, "moe")
    graph_phase(model, params, GRAPH_PROMPT_LENS, rng, "moonshot", long_prompt=MOE_LONG_PROMPT)
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.int32, device=DEVICE)
    profile_step(lambda: model.decode_step(params, eng.cache, {"token": tok}), "decode step, eager (4 slots)",
                 "moe", kernels=("copy",))
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, size=(1, MOE_LONG_PROMPT)), device=DEVICE)
    for kernels, launched in ((("flash_attention_wgmma_kernel",), L), (("copy",), 0)):
        profile_step(lambda: model.prefill(params, {"tokens": toks}, 2048), f"prefill S={MOE_LONG_PROMPT}", "moe",
                     kernels=kernels, launches=launched)
    return n


def serve_whisper() -> int:
    """Full-width whisper-medium (24 encoder + 24 decoder layers, bf16) through
    the engine, which feeds zero frames: the traced session (flash in the
    encoder's 24 layers and the decoder's 24 self and 24 cross attentions of
    every prefill, none in decode), warm step times, the encoder's share of a
    prefill, the decode graph and a decode step's profile."""
    import numpy as np
    import torch

    from repro_torch.models import encdec
    from repro_torch.serve.engine import prompt_batch

    model, params = init_full_width(WHISPER, "whisper")
    cfg = model.cfg
    per = cfg.encdec.enc_layers + 2 * cfg.num_layers
    rng = np.random.default_rng(5)
    eng, _, launches, steps = traced_session(model, params, WHISPER_PROMPT_LENS, rng, "whisper")
    _finite_cache("whisper", eng.cache)
    n = _flash_gate("whisper", launches, per, len(WHISPER_PROMPT_LENS), steps)
    warm_step_times(model, params, eng, WHISPER_PROMPT_LENS, rng, "whisper")
    frames = prompt_batch(model, torch.zeros((1, 1), dtype=torch.long, device=DEVICE))["frames"]
    host, enc_ms = host_vs_device(lambda: encdec.encode(cfg, params, frames))
    for S in WHISPER_SHARE_LENS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, S)), device=DEVICE)
        _, done_ms = host_vs_device(lambda t=toks: model.prefill(params, prompt_batch(model, t), 2048))
        print(f"[whisper] the encoder ({cfg.encdec.enc_positions} frames, {cfg.encdec.enc_layers} layers): {enc_ms:.2f} ms to completion, host enqueue "
              f"{host:.2f} ms; {enc_ms / done_ms:.3f} of a {S}-token prefill's {done_ms:.2f} ms (medians of 5, warm)")
    graph_phase(model, params, GRAPH_PROMPT_LENS, rng, "whisper", long_prompt=WHISPER_SHARE_LENS[-1])
    tok = torch.zeros(eng.cfg.batch_slots, dtype=torch.int32, device=DEVICE)
    profile_step(lambda: model.decode_step(params, eng.cache, {"token": tok}), "decode step, eager (4 slots)",
                 "whisper", kernels=("copy",))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, WHISPER_SHARE_LENS[-1])), device=DEVICE)
    profile_step(lambda: model.prefill(params, prompt_batch(model, toks), 2048), f"prefill S={toks.shape[1]}", "whisper",
                 kernels=("flash_attention_wgmma_kernel",), launches=per)
    return n


def serve_llava() -> int:
    """Full-width llava-next-34b (60 layers, bf16) through ``Model.prefill`` /
    ``decode_step`` (the engine, like the JAX one, feeds no patch
    embeddings): VLM_BATCH rows of 2880 patch embeddings drawn from the seed
    and VLM_TEXT tokens, cache_len VLM_CACHE_LEN; flash in each layer of the
    prefill; VLM_STEPS decode steps through ``decode_artifacts`` (eager and
    captured, then replays), each against the eager step on a copy of the
    cache (tokens identical, cache and logits within GRAPH_TOL relative);
    then warm times, the replay's profile and the peak memory."""
    import numpy as np
    import torch

    from repro_torch.serve.artifacts import DecodeGraph, decode_artifacts

    model, params = init_full_width(LLAVA, "vlm")
    cfg = model.cfg
    V, B = cfg.vocab_size, VLM_BATCH
    g = torch.Generator(device=DEVICE).manual_seed(7)
    batch = {
        "tokens": torch.randint(0, V, (B, VLM_TEXT), device=DEVICE, generator=g),
        "patch_embeds": (0.02 * torch.randn(B, cfg.vision_tokens, cfg.d_model, device=DEVICE, generator=g)).to(
            torch.bfloat16),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, VLM_CACHE_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step = decode_artifacts(model, DEVICE)
    if not isinstance(step, DecodeGraph):
        raise AssertionError(f"the decode step is {step!r}, not a DecodeGraph")
    eager = _clone(cache)
    tok = torch.argmax(logits[:, 0, :V], dim=-1).to(torch.int32)
    worst = {"logits": 0.0, "cache": 0.0}
    for i in range(VLM_STEPS):
        for a, b in zip(_leaves(eager), _leaves(cache), strict=True):
            a.copy_(b)
        eager_tok = tok.clone()
        got, _ = step(params, cache, {"token": tok})
        want, _ = model.decode_step(params, eager, {"token": eager_tok})
        nxt = torch.argmax(got[:, 0, :V], dim=-1).to(torch.int32)
        if not torch.equal(nxt, torch.argmax(want[:, 0, :V], dim=-1).to(torch.int32)):
            raise AssertionError(f"[vlm] decode step {i + 1}: replayed tokens differ from the eager step's")
        worst["logits"] = max(worst["logits"], _rel(got, want))
        for a, b in zip(_leaves(cache), _leaves(eager), strict=True):
            worst["cache"] = max(worst["cache"], _rel(a, b))
        tok.copy_(nxt)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if step.replays != VLM_STEPS - 1 or step.captured or max(worst.values()) > GRAPH_TOL:
        raise AssertionError(f"[vlm] {step.replays} replays, captured {step.captured}, graph against eager {worst}")
    _finite_cache("vlm", cache)
    if cache["len"].tolist() != [cfg.vision_tokens + VLM_TEXT + VLM_STEPS] * B:
        raise AssertionError(f"[vlm] cache lengths {cache['len'].tolist()}")
    n = _flash_gate("vlm", launches, cfg.num_layers, 1, VLM_STEPS)
    print(f"[vlm] {cfg.name}, all {cfg.num_layers} layers: B={B}, {cfg.vision_tokens} patch embeddings + "
          f"{VLM_TEXT} tokens, cache_len {VLM_CACHE_LEN}: first prefill {prefill_s:.2f} s; {VLM_STEPS} decode "
          f"steps ({step.replays} replays), tokens identical to the eager step, largest relative difference logits "
          f"{worst['logits']:.3g}, cache {worst['cache']:.3g} (tol {GRAPH_TOL}); peak device memory "
          f"{peak / 2**30:.3f} GiB")
    del eager
    host, done_ms = host_vs_device(lambda: model.prefill(params, batch, VLM_CACHE_LEN))
    print(f"[vlm] prefill B={B} S={cfg.vision_tokens + VLM_TEXT}: {done_ms:.2f} ms to completion, host enqueue "
          f"{host:.2f} ms (median of 5, warm)")
    dbatch = {"token": tok}
    host, done_ms = host_vs_device(lambda: step(params, cache, dbatch))
    ehost, edone = host_vs_device(lambda: model.decode_step(params, cache, dbatch))
    print(f"[vlm] decode step ({B} rows): replay {done_ms:.2f} ms to completion, host enqueue {host:.3f} ms; eager "
          f"{edone:.2f} ms, host enqueue {ehost:.2f} ms (medians of 5, warm); {B / done_ms * 1e3:.2f} tokens/s "
          "replayed")
    busy = profile_step(lambda: step(params, cache, dbatch), f"decode step, replay ({B} rows)", "vlm")
    if busy:
        print(f"[vlm] idle share of a replay against its time to completion without the profiler: "
              f"{1 - busy / done_ms:.3f}")
    return n


def serve_new_families() -> int:
    """[flash] at the new shapes was taken before; the card-against-CPU
    checks and the three full-width families in turn, each released before
    the next loads, then the launcher for the two the engine serves.
    Returns the flash launches of the three serving runs."""
    release("before [model-moe]")
    check_moe_against_cpu()
    release("before [model-ed]")
    check_whisper_against_cpu()
    release("before [model-vlm]")
    check_vlm_against_cpu()
    release("before [moe]")
    n = serve_moonshot()
    release("before [whisper]")
    n += serve_whisper()
    release("before [vlm]")
    n += serve_llava()
    release("before [launch]")
    serve_launcher(NEW_LAUNCH_RUNS)
    return n


# ---------------------------------------------------------------------------
# The full-mode polling fence, and the command-line entry point
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# [train]: full-width h2o-danube-1.8b trained, then its checkpoint served
# ---------------------------------------------------------------------------

TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_SEQ, TRAIN_BATCH = 1024, 4
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
#: the step call that raises (an injected transient failure): the trainer
#: restores the newest checkpoint and replays from it
TRAIN_FAIL_AT = 6
#: peak learning rate (2 warmup steps, as the launcher's): at full width
#: AdamW moves every weight by about the rate each step, and at 1e-3 and
#: 1e-4 the loss rose within 8 steps
TRAIN_LR = 3e-5
#: (batch rows, tokens) of the two-layer card-against-CPU train step
TRAIN_CPU_CASE = (1, 512)
TRAIN_SERVE_LENS = (100, 512, 1024, 512)
TRAIN_NEW_TOKENS = 8
#: a kernel name part that marks a matrix product (cuBLAS / CUTLASS)
MATMUL_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "sm90_")


def check_train_against_cpu() -> None:
    """Two full-width h2o-danube-1.8b layers, fp32: one train step, the card
    against the CPU (``_train_step_against_cpu``)."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2, dtype="float32")
    B, S = TRAIN_CPU_CASE
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    _train_step_against_cpu(cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 7, "train",
                            f"2-layer full-width fp32 train step, {B} x {S} tokens")


@contextlib.contextmanager
def _expert_inputs():
    """Records (layer parameters, input) of each MoE expert layer called in
    the ``with`` block, for its routing to be recomputed."""
    from repro_torch.models import moe

    seen, moe_ffn = [], moe.moe_ffn
    moe.moe_ffn = lambda c, pl, h: seen.append((pl, h.detach())) or moe_ffn(c, pl, h)
    try:
        yield seen
    finally:
        moe.moe_ffn = moe_ffn


def _train_step_against_cpu(cfg, batch: dict, seed: int, tag: str, what: str) -> None:
    """One train step of ``cfg`` (fp32) on numpy ``batch``: its loss, global
    gradient norm and every gradient, the card (plain PyTorch under
    autograd, as the JAX train step) against the CPU; and the AdamW update
    of both sides from the CPU's gradients (each side's own gradients reach
    the update divided by sqrt(v) + eps, which magnifies the differences of
    gradients near eps).  Each within ``CPU_REL_LIMIT[tag]`` of max|cpu|.
    For the MoE family each layer's top-k expert sets are compared first:
    a token whose sets differ must be a near tie (else the phase fails);
    after such a flip the step's numbers are printed but not gated, since
    two experts' gradients then differ by design."""
    import torch

    from repro_torch import tree
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm
    from repro_torch.train.train_step import loss_and_grads

    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))
    sides = {DEVICE: params, "cpu": _to(params, "cpu")}
    out, grads, seen, cpu_s = {}, {}, {}, 0.0
    t_init = time.perf_counter() - t0
    for dev, p in sides.items():
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        with _expert_inputs() as seen[dev]:
            loss, grads[dev], metrics = loss_and_grads(model, p, b)
        out[dev] = {"loss": loss, "aux": metrics["aux"], "grad_norm": global_norm(grads[dev])}
        out[dev].update({f"grad {k}": g for k, g in tree.items(grads[dev])})
        cpu_s = time.perf_counter() - t0
    flipped, near = [], 0
    for l, ((pl, h), (pl_cpu, h_cpu)) in enumerate(zip(seen[DEVICE], seen["cpu"], strict=True)):
        ids, _ = _routing(cfg, pl, h)
        ids_cpu, probs_cpu = _routing(cfg, pl_cpu, h_cpu)
        flipped += [(l, t) for t in _near_ties(cfg, ids, ids_cpu, probs_cpu, f"{tag} layer {l}")]
        top = probs_cpu.topk(cfg.moe.top_k + 1, dim=-1).values
        near += int((top[:, -2] - top[:, -1] < NEAR_TIE).sum())
    t0 = time.perf_counter()
    for dev, p in sides.items():
        g = tree.map(lambda t: t.to(dev), grads["cpu"])
        p = tree.map(torch.clone, p)
        new, _, _ = adamw_update(g, adamw_init(p, AdamWConfig()), p, TRAIN_LR, AdamWConfig())
        out[dev].update({f"updated {k}": w for k, w in tree.items(new)})
        del g, p, new
    t_adamw = time.perf_counter() - t0
    t0 = time.perf_counter()
    if flipped:
        rels = {name: _rel(out[DEVICE][name].cpu(), b) for name, b in out["cpu"].items()}
    else:
        rels = {name: _within(tag, name, out[DEVICE][name], b) for name, b in out["cpu"].items()}
    worst = {grp: max((r, n) for n, r in rels.items() if n.split(" ")[0] == grp) for grp in ("grad", "updated")}
    routing = ""
    if seen[DEVICE]:
        routing = (f"; top-k expert sets of {len(seen[DEVICE])} layers: {near} near tie(s) (CPU gap under "
                   f"{NEAR_TIE}), {len(flipped)} flipped {flipped}" +
                   (" (so the numbers above are printed, not gated)" if flipped else ", all sets equal"))
    print(f"[{tag}] {what}, card vs cpu max|d|/max|cpu| (limit {CPU_REL_LIMIT[tag]:g}): loss "
          f"{rels['loss']:.3g} ({float(out['cpu']['loss']):.6f}); aux {rels['aux']:.3g} "
          f"({float(out['cpu']['aux']):.6f}); grad_norm {rels['grad_norm']:.3g}; gradients up to "
          f"{worst['grad'][0]:.3g} ({worst['grad'][1]}); AdamW-updated weights from the CPU's gradients up to "
          f"{worst['updated'][0]:.3g} ({worst['updated'][1]}){routing}; the CPU's loss and gradients took "
          f"{cpu_s:.1f} s (init and copy to the CPU {t_init:.1f} s, AdamW on both sides {t_adamw:.1f} s, "
          f"the comparisons {time.perf_counter() - t0:.1f} s){'' if flipped else ' ok'}")


def _train_rows(tally) -> dict:
    return {api: (tally.apis[("ust_repro", api)].calls if ("ust_repro", api) in tally.apis else 0)
            for api in ("train_step", "data_next", "optimizer_update", "checkpoint_save", "checkpoint_restore")}


def _range_kernels(events, name: str) -> list:
    """The device kernels (``profiler_util.Kernel``) of the profiled step
    under the profiler range ``name``: those launched under it in the
    forward pass, and under the backward node of an operation launched
    there (the node carries its forward operation's thread and sequence
    number).  Each kernel belongs to one innermost operation, so none counts
    twice; the range's own device-side annotation is not a kernel."""

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    fwd = {(e.thread, e.sequence_nr) for e in events
           if e.sequence_nr >= 0 and any(a.name == name for a in ancestors(e))}

    def inside(e):
        return any(a.name == name or (a.scope == 1 and (a.fwd_thread, a.sequence_nr) in fwd)
                   for a in ancestors(e))

    return [k for e in events if e.kernels and inside(e) for k in e.kernels if k.name != name]


def _attention_range():
    """The danube and moonshot steps' attention: ``attend_cfg`` as the
    training block calls it."""
    from repro_torch.models import transformer

    return {"attention (attend_cfg forward and backward)": (transformer, "attend_cfg")}


def _profile_shares(model, trainer, tag: str = "train", ranges=None) -> None:
    """One more step, profiled in two sessions: the loss and its gradients,
    then the AdamW update.  Prints each session's device busy time and idle
    share, and the step's device time split into disjoint parts: one for
    each of ``ranges`` ({label: (module, function name)}, default the
    attention: the function, as the model calls it, runs inside a profiler
    range of its own, and its part is the kernels of its forward and of
    its operations' backward nodes), the matrix products outside them, the
    AdamW update and the rest; and the longest kernels.  A measurement: it
    prints, and fails only on a session without device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.optim import adamw_update, warmup_cosine
    from repro_torch.train.train_step import loss_and_grads

    ranges = ranges or _attention_range()
    tcfg = trainer.tcfg
    state = trainer.state
    batch = trainer._device_batch(trainer.pipe.batch_at(trainer.pipe.step))
    lr = warmup_cosine(state["opt"]["count"], peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.total_steps)
    sessions, grads = {}, None
    names = {label: f"train_range_{i}" for i, label in enumerate(ranges)}

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    def run_grads():
        nonlocal grads
        originals = {label: getattr(mod, attr) for label, (mod, attr) in ranges.items()}
        for label, (mod, attr) in ranges.items():
            setattr(mod, attr, ranged(names[label], originals[label]))
        try:
            grads = loss_and_grads(model, state["params"], batch)[1]
        finally:
            for label, (mod, attr) in ranges.items():
                setattr(mod, attr, originals[label])

    def run_update():
        adamw_update(grads, state["opt"], state["params"], lr, tcfg.adamw)

    for label, fn in (("loss and gradients", run_grads), ("AdamW update", run_update)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        # the profiler mirrors each range on the device as an annotation
        # spanning its kernels: not device work of its own
        dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in names.values()]
        if not dev:
            print(f"[{tag}] profile {label}: wall {wall:.2f} ms; the profiler recorded no device time (not measured)")
            return
        sessions[label] = (wall, dev, events)
    busy = {k: sum(e.time_range.elapsed_us() for e in dev) / 1e3 for k, (_, dev, _) in sessions.items()}
    total = sum(busy.values())
    for label, (wall, dev, _) in sessions.items():
        print(f"[{tag}] profile {label}: wall {wall:.2f} ms, device busy {busy[label]:.2f} ms ({len(dev)} device "
              f"ops), idle share {1 - busy[label] / wall:.3f}; {busy[label] / total:.3f} of the step's device time")

    def is_mm(name):
        return any(k in name.lower() for k in MATMUL_KERNELS)

    grad_events = sessions["loss and gradients"][2]
    parts, inside_mm = [], 0.0
    for label in ranges:
        ks = _range_kernels(grad_events, names[label])
        if not ks:
            print(f"[{tag}] profiled step: no kernel was found under the range of {label} (its share not measured)")
        ms = sum(k.duration for k in ks) / 1e3
        k_mm = sum(k.duration for k in ks if is_mm(k.name)) / 1e3
        k_sm = sum(k.duration for k in ks if "softmax" in k.name.lower()) / 1e3
        inside_mm += k_mm
        parts.append((label, ms, f"; of it matrix products {k_mm:.2f} ms, softmax {k_sm:.2f} ms"))
    mm = sum(e.time_range.elapsed_us() for e in sessions["loss and gradients"][1] if is_mm(e.name)) / 1e3 - inside_mm
    parts.append(("matrix products outside " + ("it" if len(ranges) == 1 else "them"), mm, ""))
    parts.append(("AdamW update", busy["AdamW update"], ""))
    parts.append(("the rest", total - sum(ms for _, ms, _ in parts), ""))
    print(f"[{tag}] profiled step, disjoint parts of its device busy {total:.2f} ms: " +
          "; ".join(f"{label} {ms:.2f} ms ({ms / total:.3f}{more})" for label, ms, more in parts))
    by_name: dict = {}
    for _, dev, _ in sessions.values():
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[{tag}]   {ms:8.3f} ms  {name[:110]}")
    del grads


def train_full_width() -> tuple:
    """Full-width h2o-danube-1.8b (24 layers, bf16 weights, fp32 AdamW
    moments) trained through ``Trainer`` for TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ ``SyntheticPipeline`` tokens under a default-mode
    trace, checkpointing every TRAIN_CKPT_EVERY steps, the TRAIN_FAIL_AT-th
    step call failing once; then the checkpoint restored from disk into
    ``ServeEngine`` for TRAIN_SERVE_LENS prompts, TRAIN_NEW_TOKENS new
    tokens each.  Gates: finite losses whose last two average below the
    first; the tally's framework rows (the replayed and failed steps, the
    saves and the restore); the checkpoint's weights equal the trained
    state's bit for bit; 24 flash launches a prefill in serving, none in
    decode.  Returns the flash launches and the loss of each step."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer, latest_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import render, tally_trace
    from repro_torch.models import Model, ShapeSpec
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg)
    shape = ShapeSpec("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    work = tempfile.mkdtemp(prefix="thapi_train_")
    ckpt_dir, trace_dir = os.path.join(work, "ckpt"), os.path.join(work, "trace")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(model, shape, DEVICE, TrainConfig(peak_lr=TRAIN_LR, warmup=2, total_steps=100),
                          TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt_dir))
        trainer.ckpt = Checkpointer(ckpt_dir, keep=1)  # one 18 GB restore point on disk at a time
        torch.cuda.synchronize()
        state_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(trainer.state))
        print(f"[train] {cfg.name}: {cfg.num_layers} layers, {_numel(trainer.state['params'])} parameters, "
              f"{cfg.dtype} weights, {trainer.tcfg.adamw.state_dtype} moments: state {state_bytes / 1e9:.2f} GB, "
              f"init {time.perf_counter() - t0:.1f} s; {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
        step, times, calls = trainer.step_fn, [], [0]

        def timed_step(state, batch):
            calls[0] += 1
            if calls[0] == TRAIN_FAIL_AT:
                raise RuntimeError("injected node failure")
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return out

        trainer.step_fn = timed_step
        t0 = time.perf_counter()
        with Tracer(TraceConfig(out_dir=trace_dir, mode="default")):
            res = trainer.run()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        tally = tally_trace(trace_dir)
        print(render(tally, top=12))
        losses = [h["loss"] for h in res["history"]]
        norms = ", ".join(f"{h['grad_norm']:.3f}" for h in res["history"])
        print(f"[train] {res['steps_run']} steps in {wall:.1f} s (checkpoints and the replay included), "
              f"{res['failures']} failure(s); losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms {norms}")
        if res["failures"] != 1 or trainer.step != TRAIN_STEPS:
            raise AssertionError(f"[train] failures {res['failures']}, step {trainer.step}: want 1 and {TRAIN_STEPS}")
        if not all(np.isfinite(losses)):
            raise AssertionError("[train] non-finite loss")
        if not (losses[-1] + losses[-2]) / 2 < losses[0]:
            raise AssertionError(f"[train] the loss did not fall: {losses}")
        replayed = TRAIN_FAIL_AT - 1 - TRAIN_CKPT_EVERY
        want = {"train_step": TRAIN_STEPS + replayed + 1, "data_next": TRAIN_STEPS + replayed + 1,
                "optimizer_update": TRAIN_STEPS + replayed,
                "checkpoint_save": TRAIN_STEPS // TRAIN_CKPT_EVERY + 1, "checkpoint_restore": 1}
        rows = _train_rows(tally)
        if rows != want:
            raise AssertionError(f"[train] framework rows {rows}, want {want}")
        saves = tally.apis[("ust_repro", "checkpoint_save")]
        restore = tally.apis[("ust_repro", "checkpoint_restore")]
        print(f"[train] framework rows {rows} (the failed call and {replayed} replayed step(s) included); "
              f"checkpoint save avg {saves.avg_ns / 1e9:.2f} s (background), restore {restore.avg_ns / 1e9:.2f} s")
        warm = sorted(times[1:])
        step_s = warm[len(warm) // 2]
        flops = model.model_flops_per_token() * shape.tokens
        print(f"[train] warm step {step_s * 1e3:.2f} ms (median of {len(warm)}; range {warm[0] * 1e3:.2f}-"
              f"{warm[-1] * 1e3:.2f}; the first {times[0] * 1e3:.2f}), {shape.tokens / step_s:.1f} tokens/s, MFU "
              f"{flops / step_s / _card().peak_flops:.4f} (6 N tokens / step time / {_card().peak_flops:g}); peak "
              f"allocated {peak / 2**30:.3f} GiB; {card_line()}")

        path = latest_checkpoint(ckpt_dir)
        if path is None or not path.endswith(f"step_{TRAIN_STEPS}"):
            raise AssertionError(f"[train] newest checkpoint {path}, want step_{TRAIN_STEPS}")
        t0 = time.perf_counter()
        restored, man = Checkpointer(ckpt_dir).restore(path, {"params": model.shapes()}, device=DEVICE)
        params = restored["params"]
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(tree.leaves(params), tree.leaves(trainer.state["params"]), strict=True))
        print(f"[train] restored {path} (step {man.step}, {sum(m['nbytes'] for m in man.leaves) / 1e9:.2f} GB on "
              f"disk) for serving: {_numel(params)} parameters in {time.perf_counter() - t0:.1f} s, bit for bit the "
              f"trained weights: {same}")
        if man.step != TRAIN_STEPS or not same:
            raise AssertionError("[train] the restored checkpoint is not the trained state")
        _profile_shares(model, trainer)
        del trainer, step
        release("after training")
        flash = serve_trained(model, params, TRAIN_SERVE_LENS, "train-serve", os.path.join(work, "serve"),
                              cfg.num_layers, "the trained checkpoint")
        del params, restored
        return flash, {h["step"]: h["loss"] for h in res["history"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_trained(model, params, lens, tag: str, serve_dir: str, per_prefill: int, what: str) -> int:
    """Trained weights through ``ServeEngine`` under a default-mode trace:
    a request for each of ``lens`` prompt lengths, TRAIN_NEW_TOKENS new
    tokens each, 4 slots, cache_len 2048.  Gates: every request its tokens,
    inside the vocabulary, one prefill row a request, flash ``per_prefill``
    x the prefills and no other kernel.  Returns the flash launches."""
    import numpy as np
    import torch

    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import tally_trace
    from repro_torch.serve import ServeConfig, ServeEngine

    V = model.cfg.vocab_size
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, cache_len=2048, max_new_tokens=TRAIN_NEW_TOKENS))
    rng = np.random.default_rng(8)
    for S in lens:
        eng.submit(rng.integers(0, V, size=(S,)))
    reset_launches()
    with Tracer(TraceConfig(out_dir=serve_dir, mode="default")):
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    launches = read_launches()
    st = tally_trace(serve_dir)
    n = len(lens)
    if len(done) != n or any(len(r.out_tokens) != TRAIN_NEW_TOKENS for r in done):
        raise AssertionError(f"[{tag}] not every request got its tokens")
    if any(not 0 <= t < V for r in done for t in r.out_tokens):
        raise AssertionError(f"[{tag}] token outside the vocabulary")
    prefills = st.apis[("ust_repro", "prefill")].calls
    decodes = st.apis[("ust_repro", "decode_step")].calls
    if prefills != n:
        raise AssertionError(f"[{tag}] {prefills} prefill rows, want {n}")
    flash = _flash_gate(tag, launches, per_prefill, n, decodes)
    print(f"[{tag}] {what} served {n} requests ({', '.join(map(str, lens))} tokens), "
          f"{sum(len(r.out_tokens) for r in done)} tokens in {serve_s:.2f} s; first tokens "
          f"{[r.out_tokens[:4] for r in done]}")
    return flash


def train_phase() -> tuple:
    """[train]: the two-layer card-against-CPU step, then full-width training
    and serving of its checkpoint; returns the flash launches and the loss
    of each step."""
    release("before [train]")
    check_train_against_cpu()
    release("after the two-layer train step")
    return train_full_width()


# ---------------------------------------------------------------------------
# [train-moe-audio]: whisper-medium and a reduced-depth full-width moonshot
# trained as the JAX package trains them, then served
# ---------------------------------------------------------------------------

#: (batch rows, decoder tokens) of the two-layer card-against-CPU train steps
FAMILY_TRAIN_CPU_CASE = (1, 128)
#: whisper's published decoder context, 4 rows of 1500 frames each
WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH = 448, 4
WHISPER_TRAIN_STEPS, WHISPER_CKPT_AT = 6, 4
WHISPER_TRAIN_SERVE_LENS = (32, 256, 448)
#: moonshot at full width does not fit one card in training (28.06 B
#: parameters: 56 GB of bf16 weights and 224 GB of fp32 moments); 4 of its
#: 48 layers do (2.95 B parameters, 29.5 GB of state, 5.9 GB of gradients)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 1024, 2, 6
MOE_TRAIN_SERVE_LENS = (256, 1024)


def check_train_families_against_cpu() -> None:
    """Two-layer full-width fp32 train steps, card against CPU: moonshot
    (1.81 B parameters; its expert sets compared first) and whisper (two
    encoder and two decoder layers over 1500 random frames)."""
    import numpy as np

    from repro_torch.configs import get_config

    B, S = FAMILY_TRAIN_CPU_CASE
    rng = np.random.default_rng(9)
    cfg = dataclasses.replace(get_config(MOONSHOT), num_layers=2, dtype="float32")
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    _train_step_against_cpu(cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 9, "train-moe",
                            f"2-layer full-width fp32 train step, {B} x {S} tokens")
    release("after the two-layer moonshot step")
    base = get_config(WHISPER)
    cfg = dataclasses.replace(base, num_layers=2, dtype="float32",
                              encdec=dataclasses.replace(base.encdec, enc_layers=2))
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encdec.enc_positions, cfg.d_model)).astype(np.float32)
    _train_step_against_cpu(cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}, 10,
                            "train-ed", f"2 encoder + 2 decoder full-width layers, fp32 train step, "
                            f"{cfg.encdec.enc_positions} random frames, {B} x {S} tokens")


def _traced_training(model, shape, steps: int, tag: str, work: str, ckpt_every: int = 0, snapshot_at: int = 0):
    """``Trainer`` for ``steps`` steps under a default-mode trace, each step
    synchronized and timed, its aux read, and the flash launches counted
    from just before the run to just after it; with ``ckpt_every`` a
    checkpoint every that many steps (keep 2) under ``work``, and at step
    ``snapshot_at`` a host copy of the weights.  Gates: finite losses whose
    last two average below the first, no flash launch, the framework rows.
    Returns (trainer, per-step aux, warm step s, tally, snapshot)."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.plugins.tally import render, tally_trace
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = model.cfg
    ckpt_dir, trace_dir = os.path.join(work, "ckpt"), os.path.join(work, "trace")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(model, shape, DEVICE, TrainConfig(peak_lr=TRAIN_LR, warmup=2, total_steps=100),
                      TrainerConfig(steps=steps, ckpt_every=ckpt_every or steps,
                                    ckpt_dir=ckpt_dir if ckpt_every else None))
    if ckpt_every:
        trainer.ckpt = Checkpointer(ckpt_dir, keep=2)
    torch.cuda.synchronize()
    n_params = _numel(trainer.state["params"])
    state_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(trainer.state))
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers" +
          (f" + {cfg.encdec.enc_layers} encoder layers" if cfg.encdec else "") +
          f", {n_params} parameters, {cfg.dtype} weights, {trainer.tcfg.adamw.state_dtype} moments: state "
          f"{state_bytes / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s; {steps} steps of "
          f"{shape.global_batch} x {shape.seq_len} tokens" +
          (f" over {cfg.encdec.enc_positions} frames a row" if cfg.encdec else ""))
    step, times, auxes, snap = trainer.step_fn, [], [], {}

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        auxes.append(float(out[1]["aux"]))
        if len(times) == snapshot_at:
            snap.update(tree.items(tree.map(lambda t: t.to("cpu", copy=True), state["params"])))
        return out

    trainer.step_fn = timed_step
    reset_launches()
    t0 = time.perf_counter()
    with Tracer(TraceConfig(out_dir=trace_dir, mode="default")):
        res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    tally = tally_trace(trace_dir)
    print(render(tally, top=10))
    losses = [h["loss"] for h in res["history"]]
    print(f"[{tag}] {res['steps_run']} steps in {wall:.1f} s (checkpoints included); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; aux {', '.join(f'{a:.4f}' for a in auxes)}; grad norms "
          f"{', '.join(f'{h['grad_norm']:.3f}' for h in res['history'])}; kernel launches in the steps {launches}")
    if res["failures"] or trainer.step != steps or not all(np.isfinite(losses + auxes)):
        raise AssertionError(f"[{tag}] failures {res['failures']}, step {trainer.step}, losses {losses}, aux {auxes}")
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"[{tag}] a kernel ran in a train step: {launches}")
    saves = (steps // ckpt_every + 1) if ckpt_every else 0
    want = {"train_step": steps, "data_next": steps, "optimizer_update": steps, "checkpoint_save": saves,
            "checkpoint_restore": 0}
    rows = _train_rows(tally)
    if rows != want:
        raise AssertionError(f"[{tag}] framework rows {rows}, want {want}")
    warm = sorted(times[1:])
    step_s = warm[len(warm) // 2]
    print(f"[{tag}] framework rows {rows}; warm step {step_s * 1e3:.2f} ms (median of {len(warm)}; range "
          f"{warm[0] * 1e3:.2f}-{warm[-1] * 1e3:.2f}; the first {times[0] * 1e3:.2f}), {shape.tokens / step_s:.1f} "
          f"tokens/s; peak allocated {peak / 2**30:.3f} GiB; {card_line()}")
    return trainer, auxes, step_s, tally, snap


def train_whisper() -> int:
    """Full-width whisper-medium (24 + 24 layers, bf16 weights, fp32
    moments) trained through ``Trainer`` for WHISPER_TRAIN_STEPS steps of
    WHISPER_TRAIN_BATCH x WHISPER_TRAIN_SEQ tokens, each row over 1500
    frames of the pipeline, checkpointing at step WHISPER_CKPT_AT (and at
    the end, as the trainer does); the step-WHISPER_CKPT_AT checkpoint
    restored from disk, bit for bit the weights after that step, and
    served: flash 72 x the prefills.  Returns the flash launches."""
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import Model, ShapeSpec, encdec

    model = Model(get_config(WHISPER))
    cfg = model.cfg
    shape = ShapeSpec("chip", "train", WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH)
    work = tempfile.mkdtemp(prefix="thapi_train_whisper_")
    try:
        trainer, _, step_s, tally, snap = _traced_training(model, shape, WHISPER_TRAIN_STEPS, "train-whisper", work,
                                                           ckpt_every=WHISPER_CKPT_AT, snapshot_at=WHISPER_CKPT_AT)
        p = trainer.state["params"]
        n_enc = _numel(p["enc_blocks"]) + _numel(p["ln_enc"])
        frames = WHISPER_TRAIN_BATCH * cfg.encdec.enc_positions
        executed = 6 * (n_enc * frames + (_numel(p) - n_enc - _numel(p["pos_enc"])) * shape.tokens)
        print(f"[train-whisper] MFU {model.model_flops_per_token() * shape.tokens / step_s / _card().peak_flops:.4f} "
              f"(6 N tokens / step time / {_card().peak_flops:g}, N = {model.cfg.active_params()}, the decoder's "
              f"{shape.tokens} tokens only); the executed matrix work 6 (N_enc frames + N_dec tokens) = "
              f"{executed:.4g} FLOPs ({frames} frames through {n_enc} encoder parameters) at "
              f"{executed / step_s / _card().peak_flops:.4f} of the peak; attention not counted in either")
        saves = tally.apis[("ust_repro", "checkpoint_save")]
        path = os.path.join(work, "ckpt", f"step_{WHISPER_CKPT_AT}")
        t0 = time.perf_counter()
        restored, man = Checkpointer(os.path.join(work, "ckpt")).restore(path, {"params": model.shapes()},
                                                                         device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        params = restored["params"]
        same = man.step == WHISPER_CKPT_AT and all(
            a.dtype == snap[k].dtype and torch.equal(a.cpu(), snap[k]) for k, a in tree.items(params))
        print(f"[train-whisper] checkpoint save avg {saves.avg_ns / 1e9:.2f} s over {saves.calls} (background); "
              f"restored {path} (step {man.step}, {sum(m['nbytes'] for m in man.leaves) / 1e9:.2f} GB on disk) "
              f"for serving in {restore_s:.1f} s: {_numel(params)} parameters, bit for bit the weights after step "
              f"{WHISPER_CKPT_AT}: {same}")
        if not same:
            raise AssertionError("[train-whisper] the restored checkpoint is not the state after its step")
        _profile_shares(model, trainer, "train-whisper",
                        {"attention (layers.attend forward and backward)": (encdec, "attend")})
        del trainer, snap
        release("after training whisper")
        per = cfg.encdec.enc_layers + 2 * cfg.num_layers
        n = serve_trained(model, params, WHISPER_TRAIN_SERVE_LENS, "train-whisper-serve", os.path.join(work, "serve"),
                          per, f"the step-{WHISPER_CKPT_AT} checkpoint")
        del params, restored
        return n
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _routing_spread(model, params, batch) -> str:
    """Each layer's routing of ``batch`` (no gradient): the experts chosen
    by any token, the largest share of tokens one expert takes, the top_k
    experts' mean probability mass, and the layer's E·Σ f·p (the aux term:
    top_k under uniform routing, E times the chosen experts' mean mass when
    every token chooses the same top_k)."""
    import torch

    cfg = model.cfg
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    with _expert_inputs() as seen, torch.no_grad():
        model.logits(params, batch)
    rows = []
    for l, (pl, h) in enumerate(seen):
        ids, probs = _routing(cfg, pl, h)
        share = torch.bincount(ids.flatten(), minlength=E).float() / ids.shape[0]
        mass = probs.topk(k, dim=-1).values.sum(-1).mean()
        rows.append(f"layer {l}: {int((share > 0).sum())} experts chosen, largest share {share.max():.3f}, top-{k} "
                    f"mass {mass:.3f}, E·Σ f·p {E * (share * probs.mean(0)).sum():.3f}")
    return "; ".join(rows)


def train_moonshot() -> int:
    """Full-width moonshot-v1-16b-a3b at MOE_TRAIN_LAYERS layers (bf16
    weights, fp32 moments) trained through ``Trainer`` for MOE_TRAIN_STEPS
    steps of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens, no checkpoint; each
    step's aux finite and in (0, E], the bounds of E·Σ f·p (Σ f = top_k,
    each f at most 1, Σ p = 1), printed beside each layer's routing of the
    next batch; then the trained weights served from memory: flash
    MOE_TRAIN_LAYERS x the prefills.  Returns the flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, ShapeSpec, moe, transformer

    cfg = dataclasses.replace(get_config(MOONSHOT), num_layers=MOE_TRAIN_LAYERS)
    model = Model(cfg)
    k = cfg.moe.top_k
    print(f"[train-moe] depth {MOE_TRAIN_LAYERS} of {get_config(MOONSHOT).num_layers} layers at full width: the "
          f"whole model's training state (28.06 B parameters: 56 GB of bf16 weights, 224 GB of fp32 moments) does "
          f"not fit one 80 GB card")
    shape = ShapeSpec("chip", "train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    work = tempfile.mkdtemp(prefix="thapi_train_moe_")
    try:
        trainer, auxes, step_s, _, _ = _traced_training(model, shape, MOE_TRAIN_STEPS, "train-moe", work)
        E = cfg.moe.num_experts
        if not all(0 < a <= E for a in auxes):
            raise AssertionError(f"[train-moe] aux {auxes}: want each in (0, {E}]")
        spread = _routing_spread(model, trainer.state["params"],
                                 trainer._device_batch(trainer.pipe.batch_at(trainer.pipe.step)))
        print(f"[train-moe] aux {min(auxes):.4f}-{max(auxes):.4f} (top_k = {k} under uniform routing, at most "
              f"E = {E}); the next batch's routing after training: {spread}")
        n_all = _numel(trainer.state["params"])
        n_act = cfg.active_params()
        print(f"[train-moe] MFU by 6 "
              f"N_active ({n_act} active parameters) {6 * n_act * shape.tokens / step_s / _card().peak_flops:.4f}; "
              f"the work executed, 6 N_all ({n_all} parameters: _moe_dense runs all {cfg.moe.num_experts} experts "
              f"on every token, {cfg.moe.num_experts / k:.1f}x the routed expert products), at "
              f"{6 * n_all * shape.tokens / step_s / _card().peak_flops:.4f} of {_card().peak_flops:g}; attention not "
              "counted in either")
        n = serve_trained(model, trainer.state["params"], MOE_TRAIN_SERVE_LENS, "train-moe-serve",
                          os.path.join(work, "serve"), cfg.num_layers, "the trained weights, from memory,")
        _profile_shares(model, trainer, "train-moe", {
            "attention (attend_cfg forward and backward)": (transformer, "attend_cfg"),
            "the expert layer (_moe_dense: router, all experts' products, combine)": (moe, "_moe_dense")})
        del trainer
        return n
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_families_phase() -> int:
    """[train-moe-audio]: the two-layer card-against-CPU steps, then whisper
    and moonshot trained and served in turn, each released before the next
    loads; returns the flash launches of the serving runs."""
    t0 = time.perf_counter()
    release("before [train-moe-audio]")
    check_train_families_against_cpu()
    t1 = time.perf_counter()
    release("before [train-whisper]")
    n = train_whisper()
    t2 = time.perf_counter()
    release("before [train-moe]")
    n += train_moonshot()
    release("after [train-moe-audio]")
    t3 = time.perf_counter()
    print(f"[train-moe-audio] the phase {t3 - t0:.1f} s: two-layer checks {t1 - t0:.1f} s, whisper {t2 - t1:.1f} s, "
          f"moonshot {t3 - t2:.1f} s")
    return n


# ---------------------------------------------------------------------------
# [remediation]: the closed loop on full-width h2o-danube-1.8b, in process,
# then the distributed_train example's modes on the card
# ---------------------------------------------------------------------------

#: the driver thread flags the trainer's rank as a straggler at every step
#: boundary from this step on
REMEDIATION_FLAG_FROM = 2
REMEDIATION_SOURCE = "rank0"
#: each wait for the loop (the replace decision after the drain checkpoint)
REMEDIATION_WAIT_S = 120.0
#: the replacement's losses against [train]'s at the same steps, max
#: |d| / |train|: the same kernels on the same data give the same bits
REMEDIATION_LOSS_REL_LIMIT = 0.0
EXAMPLE = "repro_torch.examples.distributed_train"
#: each example run's own time limit
EXAMPLE_TIMEOUT_S = 300
#: (label, arguments, lines its standard output must hold)
EXAMPLE_RUNS = [
    ("chaos slowdown", ["--chaos", "--chaos-ranks", "3", "--chaos-steps", "25", "--chaos-seed", "0",
                        "--inject-fault", "slowdown:rank=1,after=5,factor=8"],
     ["OK: ladder walked", "(drain before evict)", "steps re-dealt", "every one traced",
      "steps completed = 3 ranks"]),
    ("chaos replace", ["--chaos", "--chaos-ranks", "3", "--chaos-steps", "25", "--chaos-seed", "0",
                       "--chaos-replace", "--inject-fault", "kill:rank=1,after=8", "--chaos-timeout", "90"],
     ["replace_admit", "(drain before replace, no eviction)", "1 replacement admitted",
      "3/3 ranks healthy at exit", "zombie fenced (fence_rejects=", "poison row absent from the composite",
      "steps completed = 3 ranks", "every one traced"]),
    ("live", ["--live", "--live-steps", "6", "--live-slow-rank", "1"],
     ["live composite matches offline combine", "per-rank sums equal the merged composite", "OK: straggler",
      "rank1 flagged"]),
    ("default", ["--steps", "200"], ["validation: clean"]),
]


def drain_and_replace(train_losses: dict) -> None:
    """Full-width h2o-danube-1.8b trained as in [train] (same constants and
    seeds, no periodic checkpoint, no injected failure) under a default-mode
    trace on the sampled rung whose ``remediation`` engine (escalate after
    one flagged window, short cooldowns) closes the loop in the tracer's
    consumer thread: escalate sets the session's rung to full, drain asks
    the trainer to drain at the next step boundary, replace raises a flag
    for this thread.  A driver thread flags the rank as a straggler at each
    step boundary from REMEDIATION_FLAG_FROM on, and as drained once the
    drain checkpoint is committed.  When ``run`` returns drained at step k,
    the trainer is freed, a new one built, ``admit_replacement(1)`` restores
    step k and ``note("replace_admit")`` records it; the replacement runs to
    TRAIN_STEPS.  Gates: the decisions escalate, drain, replace, each one
    ``ust_repro:remediation`` record in that order, then the admission's;
    the rung change is in the trace, and every step after the one the
    escalation landed in has its ``train_step`` record while the sampled
    steps before it do not all have one; one checkpoint save (the drain's)
    and one restore (the admission's) in the trace, whose spans give their
    times; 0 < k < TRAIN_STEPS; the replacement restores step k; every
    step's loss equals [train]'s within REMEDIATION_LOSS_REL_LIMIT."""
    import threading

    import torch

    from repro_torch import trace, tree
    from repro_torch.configs import get_config
    from repro_torch.core import RUNG_DRAIN, RUNG_ESCALATE, RUNG_REPLACE, RemediationEngine, RemediationHooks
    from repro_torch.core import TraceConfig, Tracer
    from repro_torch.core.babeltrace import CTFSource
    from repro_torch.core.plugins.tally import tally_trace
    from repro_torch.models import Model, ShapeSpec
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg)
    shape = ShapeSpec("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    work = tempfile.mkdtemp(prefix="thapi_remediation_")
    ckpt_dir, trace_dir = os.path.join(work, "ckpt"), os.path.join(work, "trace")

    def new_trainer():
        return Trainer(model, shape, DEVICE, TrainConfig(peak_lr=TRAIN_LR, warmup=2, total_steps=100),
                       TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1, ckpt_dir=ckpt_dir))

    box = {"trainer": None, "escalated_at": None}
    replace_asked, stop = threading.Event(), threading.Event()

    def escalate(target, reason):
        box["escalated_at"] = box["trainer"].step  # the step running when the rung changes
        trace.set_mode("full")
        return True

    def drain(target, reason):
        box["trainer"].request_drain()  # an event: the save runs on the main thread
        return True

    def replace(target, reason):
        replace_asked.set()
        return True

    # the driver reports no healthy window: the rank stays suspect until it is replaced
    engine = RemediationEngine(RemediationHooks(escalate=escalate, drain=drain, replace=replace),
                               cooldown_s=0.05, backoff_cap_s=0.05, escalate_after=1, healthy_windows=10**6)

    def driver():  # flags the first trainer's rank until it is replaced; the replacement is healthy
        t, seen = box["trainer"], -1
        while not stop.is_set() and not replace_asked.is_set():
            if t.drained:
                engine.ingest_flag(REMEDIATION_SOURCE, "drained", "awaiting replacement")
            elif not t.draining.is_set() and t.step != seen:
                seen = t.step
                if seen >= REMEDIATION_FLAG_FROM:
                    engine.ingest_flag(REMEDIATION_SOURCE, "straggler", f"step {seen}")
            time.sleep(0.01)

    try:
        t0 = time.perf_counter()
        box["trainer"] = first = new_trainer()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_gb = sum(t.numel() * t.element_size() for t in tree.leaves(first.state)) / 1e9
        thread = threading.Thread(target=driver, name="remediation-driver", daemon=True)
        with Tracer(TraceConfig(out_dir=trace_dir, mode="default", fidelity="sampled", remediation=engine)):
            thread.start()
            res = first.run()
            t_drained = time.perf_counter()
            k = first.step
            if not res["drained"] or not 0 < k < TRAIN_STEPS:
                raise AssertionError(f"[remediation] run returned drained={res['drained']} at step {k}")
            if not replace_asked.wait(REMEDIATION_WAIT_S):
                raise AssertionError(f"[remediation] no replace decision within {REMEDIATION_WAIT_S:g} s: "
                                     f"{engine.render_log()}")
            losses = {h["step"]: h["loss"] for h in res["history"]}
            thread.join()  # the driver holds the drained trainer until it sees the decision
            box["trainer"] = None
            del first, res
            release("the drained trainer freed")
            t = time.perf_counter()
            box["trainer"] = second = new_trainer()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            restored = second.admit_replacement(1)
            engine.note("replace_admit", REMEDIATION_SOURCE, f"incarnation 1 restored step {restored}")
            admit_s = time.perf_counter() - t_drained
            # restored: ``run`` neither restores again nor writes a final
            # checkpoint, so the drain's is the only one this phase writes
            second.ckpt = None
            res2 = second.run()
        wall = time.perf_counter() - t0
        losses.update({h["step"]: h["loss"] for h in res2["history"]})
        if restored != k or second.step != TRAIN_STEPS or res2["steps_run"] != TRAIN_STEPS - k:
            raise AssertionError(f"[remediation] restored step {restored}, ran {res2['steps_run']} to "
                                 f"{second.step}: want {k}, {TRAIN_STEPS - k} to {TRAIN_STEPS}")
        names = [a.action for a in engine.actions]
        if names != [RUNG_ESCALATE, RUNG_DRAIN, RUNG_REPLACE, "replace_admit"] or not all(a.ok for a in engine.actions):
            raise AssertionError(f"[remediation] decisions {names}:\n{engine.render_log()}")
        rows, steps_seen, rung_rows, polls = [], [], [], 0
        for e in CTFSource(trace_dir):
            if e.name == "ust_repro:remediation":
                rows.append(e.asdict())
            elif e.name == "ust_repro:train_step_entry":
                steps_seen.append(e.asdict()["step"])
            elif e.name == "ust_repro:advisory":
                rung_rows.append(e.asdict())
            elif e.name.startswith("ust_repro:poll_ready"):
                polls += 1
        if [r["action"] for r in rows] != names or any(r["target"] != REMEDIATION_SOURCE for r in rows):
            raise AssertionError(f"[remediation] trace rows {rows}, want one for each of {names}")
        e_step = box["escalated_at"]  # at least REMEDIATION_FLAG_FROM: the first flag escalates
        before = [s for s in steps_seen if s < e_step]
        if (not any("sampled->full" in str(r) for r in rung_rows)
                or not set(range(e_step + 1, TRAIN_STEPS)) <= set(steps_seen) or len(before) >= e_step):
            raise AssertionError(f"[remediation] escalation at step {e_step}: train_step records for steps "
                                 f"{sorted(steps_seen)}, rung rows {rung_rows}")
        tally = tally_trace(trace_dir)
        save, restore = (tally.apis.get(("ust_repro", api)) for api in ("checkpoint_save", "checkpoint_restore"))
        if save is None or restore is None or (save.calls, restore.calls) != (1, 1):
            raise AssertionError(f"[remediation] checkpoint rows: save {save}, restore {restore}; want the drain's "
                                 f"and the admission's")
        rel = max(abs(losses[s] - train_losses[s]) / abs(train_losses[s]) for s in range(1, TRAIN_STEPS + 1))
        print(f"[remediation] {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}): decisions "
              f"{' -> '.join(names)}, each one ust_repro:remediation record in the trace; escalated (sampled -> full) during step {e_step}, "
              f"train_step records for steps {sorted(set(steps_seen))} ({len(before)} of the {e_step} sampled "
              f"steps before it), {polls} poll_ready records (the rung is full, the mode default); drained at "
              f"step {k}, the replacement restored step {restored} and ran to {TRAIN_STEPS}")
        print(f"[remediation] losses {', '.join(f'{losses[s]:.4f}' for s in range(1, TRAIN_STEPS + 1))}; against "
              f"[train]'s at the same steps max relative difference {rel:.3g} (limit "
              f"{REMEDIATION_LOSS_REL_LIMIT:g})")
        print(f"[remediation] trainer init {init_s:.1f} s; drain checkpoint save {save.avg_ns / 1e9:.2f} s "
              f"({state_gb:.2f} GB of state, the loop's thread); replacement: new trainer {build_s:.1f} s, restore "
              f"{restore.avg_ns / 1e9:.2f} s (both from the trace), admitted {admit_s:.1f} s after the drain "
              f"returned; phase {wall:.1f} s; {card_line()}")
        if rel > REMEDIATION_LOSS_REL_LIMIT:
            raise AssertionError(f"[remediation] losses differ from [train]'s: {losses} against {train_losses}")
        del second, res2
    finally:
        stop.set()
        box["trainer"] = None
        shutil.rmtree(work, ignore_errors=True)


def run_example(label: str, args: list, want: list) -> str:
    """``python -m repro_torch.examples.distributed_train ARGS`` on the card
    in its own process group, with a temporary directory of its own that is
    removed after; fails unless it exits 0 within EXAMPLE_TIMEOUT_S with
    every line of ``want`` in its standard output.  Returns that output."""
    import signal

    tmp = tempfile.mkdtemp(prefix="thapi_example_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TMPDIR=tmp)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", EXAMPLE, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        print(out[-4000:], err[-4000:], file=sys.stderr)
        raise AssertionError(f"[example] {label}: no exit within {EXAMPLE_TIMEOUT_S} s") from None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    missing = [w for w in want if w not in out]
    if proc.returncode != 0 or missing or "FAIL" in out:
        print(out[-6000:], err[-4000:], file=sys.stderr)
        raise AssertionError(f"[example] {label}: exit {proc.returncode}, missing {missing}")
    for line in out.splitlines():
        if "OK" in line or line.startswith("loss:") or line.startswith("validation:") or "params on" in line:
            print(f"[example] {label}: {line.strip()}")
    print(f"[example] {label}: exit 0 in {wall:.1f} s ({' '.join(args)})")
    return out


def run_examples() -> None:
    """Every mode of the example on the card: both chaos runs, the live run
    and the default mode; the default mode's loss must fall."""
    for label, args, want in EXAMPLE_RUNS:
        out = run_example(label, args, want)
        if label == "default":
            m = re.search(r"^loss: ([0-9.]+) → ([0-9.]+) over (\d+) steps", out, re.M)
            if m is None or not float(m.group(2)) < float(m.group(1)) or int(m.group(3)) != 200:
                raise AssertionError(f"[example] default: the loss did not fall over 200 steps ({m and m.group(0)})")


def remediation_phase(train_losses: dict) -> None:
    """[remediation]: the drained and replaced full-width trainer, then the
    example's modes, each after the card is freed of the last."""
    release("before [remediation]")
    drain_and_replace(train_losses)
    release("before the example runs")
    run_examples()


# ---------------------------------------------------------------------------
# [dryrun]: the launch analytics held against the card
# ---------------------------------------------------------------------------

#: the dry run's worker processes (the card machine has 8 cores)
DRYRUN_JOBS = 4
DRYRUN_TIMEOUT_S = 300
#: the dry run's peak must lie within this share of the card's
PEAK_REL_LIMIT = 0.10
#: the step's loss and gradient norm under "dots" and "full" against "none"'s
REMAT_REL_LIMIT = 1e-2
DRYRUN_STEPS = 3  # warm steps timed after the first
DRYRUN_PREFILL_S = 4096
#: the cells refused by Model.check_trainable, and why
DRYRUN_REFUSED = {("mamba2-1.3b", "train_4k"), ("recurrentgemma-2b", "train_4k")}


def dryrun_all_cells() -> None:
    """``python -m repro_torch.launch.dryrun --arch all`` in its own
    process on meta tensors: its table and time; every cell ran but the SSM
    and hybrid train cells, refused naming ROADMAP section 4."""
    work = tempfile.mkdtemp(prefix="thapi_dryrun_")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--jobs", str(DRYRUN_JOBS),
             "-o", work],
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        )
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"[dryrun] {line}")
        if proc.returncode != 0:
            raise AssertionError(f"[dryrun] --arch all exited {proc.returncode}: {proc.stderr[-3000:]}")
        rows = []
        for name in sorted(os.listdir(work)):
            with open(os.path.join(work, name)) as f:
                rows.append(json.load(f))
        refused = {(r["arch"], r["shape"]) for r in rows if "refused" in r}
        bad = [(r["arch"], r["shape"]) for r in rows if not r["ok"] and "refused" not in r]
        if bad or refused != DRYRUN_REFUSED or any("ROADMAP section 4" not in r["refused"] for r in rows
                                                    if "refused" in r):
            raise AssertionError(f"[dryrun] failed cells {bad}; refused {sorted(refused)}")
        print(f"[dryrun] all cells: {len(rows) - len(refused)} ran, {len(refused)} refused (ROADMAP section 4), "
              f"{wall:.1f} s in its own process with {DRYRUN_JOBS} workers (meta tensors; the time should be "
              f"60 s or less); {card_line()}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _predicted(arch: str, cfg, shape) -> dict:
    """The dry run's cell on meta tensors, in this process."""
    from repro_torch.launch import dryrun

    res = dryrun.run_cell(arch, shape.name, cfg=cfg, shape=shape)
    if not res["ok"]:
        raise AssertionError(f"[dryrun] {arch} {shape.name}: {res}")
    return res["roofline"]


def _hold(tag: str, what: str, rf: dict, peak: int, t_ms: float, t_what: str) -> None:
    """The dry run's peak within PEAK_REL_LIMIT of the card's, and its bound
    at or under the measured time."""
    bound_ms = max(rf["t_compute"], rf["t_memory"]) * 1e3
    rel = abs(rf["peak_bytes"] - peak) / peak
    print(f"[{tag}] {what}: peak predicted {rf['peak_bytes'] / 2**30:.3f} GiB, on the card {peak / 2**30:.3f} GiB "
          f"(|d|/card {rel:.3f}, limit {PEAK_REL_LIMIT}); bound {bound_ms:.2f} ms ({rf['bottleneck']}: compute "
          f"{rf['t_compute'] * 1e3:.2f} ms, memory {rf['t_memory'] * 1e3:.2f} ms) against {t_what} {t_ms:.2f} ms; "
          f"roofline_fraction {rf['roofline_fraction']:.4f}, useful_flops_ratio {rf['useful_flops_ratio']:.4f}; "
          f"{card_line()}")
    if not rel <= PEAK_REL_LIMIT:
        raise AssertionError(f"[{tag}] {what}: the dry run's peak is {rel:.3f} off the card's")
    if not bound_ms <= t_ms:
        raise AssertionError(f"[{tag}] {what}: the bound {bound_ms:.2f} ms is above the measured {t_ms:.2f} ms")


def dryrun_train() -> None:
    """Full-width h2o-danube-1.8b, TRAIN_BATCH x TRAIN_SEQ tokens, the train
    step as ``[train]`` builds it, under remat none, dots and full, each on
    fresh weights from one seed and released before the next: the dry run's
    peak against the card's (after the first step, from a reset), the bound
    at or under the warm step time, dots' and full's first loss and
    gradient norm equal to none's, and the peaks ordered none >= dots >=
    full.  The order is read where remat acts, over the loss and gradients
    alone: the whole step's peak is the AdamW update's under dots and full
    alike (the activations are freed by then), and the allocator's blocks
    set those two apart by a few hundred KiB either way."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, ShapeSpec
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_step import build_train_step, init_state, loss_and_grads

    base = get_config(TRAIN_ARCH)
    shape = ShapeSpec(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", "train", TRAIN_SEQ, TRAIN_BATCH)
    toks = np.random.default_rng(11).integers(0, base.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ + 1))
    peaks, grad_peaks, first, card = {}, {}, {}, card_line()
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        rf = _predicted(TRAIN_ARCH, cfg, shape)
        model = Model(cfg)
        meta_state, meta_batch = dryrun.step_inputs(model, shape)
        with torch.enable_grad(), dryrun.Counter() as c:
            c.track(meta_state, meta_batch)
            loss_and_grads(model, meta_state["params"], meta_batch)
        grads_predicted = c.peak
        tcfg = TrainConfig(peak_lr=TRAIN_LR, warmup=2, total_steps=100, adamw=dryrun._adamw_for(cfg))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state = init_state(model, tcfg, torch.Generator(device=DEVICE).manual_seed(0))
        batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device=DEVICE),
                 "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32, device=DEVICE)}
        step = build_train_step(model, shape, tcfg, DEVICE)
        _, m = step(state, batch)
        first[remat] = (float(m["loss"]), float(m["grad_norm"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DRYRUN_STEPS):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peaks[remat] = torch.cuda.max_memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        loss_and_grads(model, state["params"], batch)
        torch.cuda.synchronize()
        grad_peaks[remat] = torch.cuda.max_memory_allocated() - before
        warm = sorted(times)[len(times) // 2]
        _hold("dryrun", f"{cfg.name} train step, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat={remat}", rf,
              peaks[remat], warm, f"the warm step (median of {DRYRUN_STEPS})")
        print(f"[dryrun] remat={remat}: the loss and gradients alone peak at {grad_peaks[remat] / 2**30:.3f} GiB "
              f"on the card, {grads_predicted / 2**30:.3f} GiB predicted; {card}")
        print(f"[dryrun] remat={remat}: first loss {first[remat][0]:.6f}, grad norm {first[remat][1]:.6f}; "
              f"MFU by 6 N tokens {rf['model_flops'] / (warm / 1e3) / _card().peak_flops:.4f}; counted FLOPs "
              f"{rf['flops']:.6g}, model FLOPs {rf['model_flops']:.6g}; {card}")
        del state, batch, step, model, m
        release(f"after the remat={remat} step")
    if not grad_peaks["none"] >= grad_peaks["dots"] >= grad_peaks["full"]:
        raise AssertionError(f"[dryrun] the card's peaks of the loss and gradients are not ordered none >= dots "
                             f">= full: {grad_peaks}")
    for remat in ("dots", "full"):
        for i, name in enumerate(("loss", "grad norm")):
            rel = abs(first[remat][i] - first["none"][i]) / abs(first["none"][i])
            if not rel <= REMAT_REL_LIMIT:
                raise AssertionError(f"[dryrun] remat={remat}: {name} {first[remat][i]} against none's "
                                     f"{first['none'][i]} ({rel:.3g} > {REMAT_REL_LIMIT})")
    print(f"[dryrun] the card's peaks of the loss and gradients none {grad_peaks['none'] / 2**30:.3f} >= dots "
          f"{grad_peaks['dots'] / 2**30:.3f} >= full {grad_peaks['full'] / 2**30:.3f} GiB (whole steps "
          f"{peaks['none'] / 2**30:.3f}, {peaks['dots'] / 2**30:.3f}, {peaks['full'] / 2**30:.3f}); dots' and full's "
          f"first loss and grad norm within {REMAT_REL_LIMIT} of none's ok; {card}")


def dryrun_prefills() -> dict:
    """The h2o-danube-1.8b prefill (the flash kernel in each of 24 layers)
    and the Mamba2-1.3B prefill (the SSD kernel in each of 48) of
    DRYRUN_PREFILL_S tokens, B=1, through the kernels: the dry run's peak
    against the card's, its bound at or under the profiled busy time, and
    the launches of one prefill, counted from 0; returns them."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model, ShapeSpec

    shape = ShapeSpec(f"prefill_{DRYRUN_PREFILL_S}", "prefill", DRYRUN_PREFILL_S, 1)
    launches = {}
    for arch, kernel, names in (("h2o-danube-1.8b", "flash_attention", ("flash_attention_wgmma_kernel",)),
                                ("mamba2-1.3b", "ssd_scan", SSD_BF16_PASSES)):
        cfg = get_config(arch)
        per = cfg.num_layers  # one launch a layer
        rf = _predicted(arch, cfg, shape)
        model = Model(cfg)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
        toks = np.random.default_rng(12).integers(0, cfg.vocab_size, size=(1, DRYRUN_PREFILL_S))
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=DEVICE)}

        def prefill():
            with torch.no_grad():
                return model.prefill(params, batch, DRYRUN_PREFILL_S)

        prefill()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        prefill()
        torch.cuda.synchronize()
        ran = read_launches()
        peak = torch.cuda.max_memory_allocated() - before
        if ran[kernel] != per or any(n for k, n in ran.items() if k != kernel):
            raise AssertionError(f"[dryrun] {arch} prefill: launches {ran}, want {per} of {kernel} only")
        launches[kernel] = ran[kernel]
        busy = profile_step(prefill, f"{arch} S={DRYRUN_PREFILL_S} prefill", "dryrun", names, per * len(names))
        _, done_ms = host_vs_device(prefill)
        t_ms, t_what = (busy, "the profiled device busy time") if busy is not None else (
            done_ms, "the warm prefill to completion (the profiler recorded no device time)")
        _hold("dryrun", f"{cfg.name} prefill, 1 x {DRYRUN_PREFILL_S} tokens, {per} {kernel} launches", rf, peak,
              t_ms, t_what)
        del params, batch, model
        release(f"after the {arch} prefill")
    return launches


def dryrun_phase() -> dict:
    """[dryrun]: every cell on meta tensors, then danube's train step and two
    prefills on the card against the dry run; returns the prefills' kernel
    launches."""
    release("before [dryrun]")
    dryrun_all_cells()
    dryrun_train()
    return dryrun_prefills()


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


#: the launcher's runs (arch, extra flags): Mamba2 with 4 requests of 512
#: tokens, the others with the defaults (8 requests of 16 tokens, cache_len
#: 64, so a 64-row ring for RecurrentGemma and h2o-danube)
LAUNCH_RUNS = [
    ("mamba2-1.3b", ["--requests", "4", "--prompt-len", "512", "--new-tokens", "8"]),
    ("recurrentgemma-2b", []),
    ("h2o-danube-1.8b", []),
]
NEW_LAUNCH_RUNS = [(MOONSHOT, []), (WHISPER, [])]


def serve_launcher(runs=LAUNCH_RUNS) -> None:
    """The command a user runs, at full width under a trace, for each model."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    for arch, extra in runs:
        trace_dir = tempfile.mkdtemp(prefix="thapi_launch_")
        try:
            reset_launches()
            rc = serve.main(["--arch", arch, "--full", "--trace", "default", "--trace-dir", trace_dir, *extra])
            launches = read_launches()
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        cfg = get_config(arch)
        if cfg.family == "ssm":
            ok = launches == {"ssd_scan": cfg.num_layers * 4, "rglru_scan": 0, "flash_attention": 0}
        elif cfg.family == "hybrid":  # 8 prefills and at least 7 decode steps, each through every recurrent block
            n_rec = cfg.block_counts()[1]
            ok = launches["ssd_scan"] == launches["flash_attention"] == 0 and launches["rglru_scan"] % n_rec == 0 and (
                launches["rglru_scan"] >= n_rec * (8 + 7)
            )
        else:  # 8 prefills, each through every attention (whisper: its encoder's, and self and cross)
            per = cfg.num_layers + (cfg.encdec.enc_layers + cfg.num_layers if cfg.family == "audio" else 0)
            ok = launches == {"ssd_scan": 0, "rglru_scan": 0, "flash_attention": per * 8}
        if rc != 0 or not ok:
            raise AssertionError(f"launcher {arch}: rc={rc}, launches {launches}")
        print(f"[launch] repro_torch.launch.serve --arch {arch} --full --trace default: rc 0, launches {launches}"
              f"{launch_detail()}")
        release(f"after the launcher's {arch}")


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
    t_start, seconds = time.perf_counter(), {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds printed and kept for the summary."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name}: {seconds[name]:.1f} s")
        return out

    timed("build", build_kernels)
    # Mamba2's phases first, in slice 1's order, so that their readings are
    # taken after the same work as before; then RecurrentGemma's, then
    # h2o-danube-1.8b's
    kernels = [timed("ssd", check_ssd)]
    timed("model", check_model_against_cpu)
    launches = dict.fromkeys(("ssd_scan", "rglru_scan", "flash_attention"), 0)
    for name, n in timed("serve", serve_full_width).items():
        launches[name] += n
    kernels.append(timed("rglru", check_rglru))
    timed("model-rg", check_hybrid_against_cpu)
    for name, n in timed("serve-rg", serve_recurrentgemma).items():
        launches[name] += n
    flash = timed("flash", check_flash)
    kernels.append(flash)
    timed("rope", check_rope_against_cpu)
    for S, cache_len in DANUBE_CPU_CASES:
        timed(f"model-dn {S}", check_dense_against_cpu, S, cache_len)
    for name, n in timed("serve-dn", serve_danube).items():
        launches[name] += n
    timed("fence", check_full_mode_fence)
    timed("launcher", serve_launcher)
    timed("iprof", iprof_phase)
    timed("live", live_phase)
    release("before [flash] at the new families' shapes")
    err, rows = timed("flash-families", check_flash_families)
    flash["max_abs_err"] = max(flash["max_abs_err"], err)
    flash["shapes"] += rows
    launches["flash_attention"] += timed("serve-families", serve_new_families)
    flash_train, train_losses = timed("train", train_phase)
    launches["flash_attention"] += flash_train
    launches["flash_attention"] += timed("train-moe-audio", train_families_phase)
    timed("remediation", remediation_phase, train_losses)
    for name, n in timed("dryrun", dryrun_phase).items():
        launches[name] += n
    print(f"[time] the phases: {'; '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}; all "
          f"{time.perf_counter() - t_start:.1f} s")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"kernel {k['name']} never ran on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
