"""iprof — THAPI's launcher/analyzer CLI (§3.4, Fig 4).

    "Tracing begins by launching the application using the iprof launcher…
     iprof allows filtering events, choosing tracing modes, turning on or off
     features such as hardware telemetry, and specifying parsing and analysis
     types for the collected traces."

Usage:
    python -m repro_torch.core.iprof run  -m default --sample -o /tmp/t -- pkg.module:main arg1 ...
    python -m repro_torch.core.iprof tally    /tmp/t [--device] [--top N] [--jobs N]
    python -m repro_torch.core.iprof index    /tmp/t              # build .ctfcol sidecars
    python -m repro_torch.core.iprof pretty   /tmp/t [-n N] [--filter memcpy]
    python -m repro_torch.core.iprof timeline /tmp/t -o timeline.json
    python -m repro_torch.core.iprof validate /tmp/t
    python -m repro_torch.core.iprof combine  /tmp/agg_root   # §3.7 batch global master

``serve``, ``top``, ``run --stream-to`` and ``run --serve-port`` need the
streaming masters, which are ported with live tracing (ROADMAP.md, item 2):
they raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Optional

from .aggregate import combine_aggregates, find_aggregates
from .plugins import pretty as pretty_plugin
from .plugins import tally as tally_plugin
from .plugins import timeline as timeline_plugin
from .plugins import validate as validate_plugin
from .tracepoints import FIDELITY_MODES
from .tracer import MODES, TraceConfig, Tracer


def _run(args) -> int:
    target = args.entry
    mod_name, _, fn_name = target.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name or "main")
    cfg = TraceConfig(
        out_dir=args.out,
        mode=args.mode,
        sample=args.sample,
        sample_period_s=args.sample_period,
        aggregate_only=args.aggregate_only,
        rank=args.rank,
        ranks=None if args.ranks is None else [int(r) for r in args.ranks.split(",")],
        online=args.online,
        stream_to=args.stream_to,
        serve_port=args.serve_port,
        ring_reserve=not args.no_ring_reserve,
        columnar=args.columnar,
        fidelity=args.fidelity,
        sampling_interval=args.sampling_interval,
        sampling_seed=args.sampling_seed,
    )
    old_argv = sys.argv
    sys.argv = [target] + list(args.args)
    try:
        with Tracer(cfg) as tr:
            fn()
    finally:
        sys.argv = old_argv
    h = tr.handle
    line = (
        f"[iprof] trace: {h.trace_dir} mode={h.mode} events={h.events} "
        f"dropped={h.dropped} bytes={h.size_bytes}"
    )
    if h.fidelity != "full":
        line += f" fidelity={h.fidelity}"
        if h.fidelity == "sampled":
            line += f" (1/{cfg.sampling_interval} systematic, tallies estimated)"
    if h.aggregate_path:
        line += f" aggregate={h.aggregate_path}"
    print(line)
    return 0


def _tally(args) -> int:
    from .ctf import stream_files

    if not stream_files(args.trace_dir):
        # zero completed streams: a valid (if sad) state — the workload
        # crashed before the first drain, traced nothing, or ran
        # --aggregate-only (use `iprof combine` there).  Render the empty
        # tally rather than erroring, but say why it is empty.
        print(
            f"[iprof] warning: no completed streams in {args.trace_dir} "
            "(empty trace, crashed workload, or aggregate-only run — "
            "see `iprof combine`); tally is empty",
            file=sys.stderr,
        )
    t = tally_plugin.tally_trace(
        args.trace_dir,
        legacy_graph=args.legacy_graph,
        jobs=args.jobs if args.jobs > 0 else None,  # 0 → one per CPU
        use_sidecar=not args.no_sidecar,
    )
    print(tally_plugin.render(t, top=args.top, device=False))
    if args.device or t.device_apis:
        print("\n-- device --")
        print(tally_plugin.render(t, top=args.top, device=True))
    return 0


def _index(args) -> int:
    from .ctf import build_sidecars

    n = build_sidecars(args.trace_dir)
    print(f"[iprof] indexed {n} stream(s): columnar sidecars written")
    return 0


def _pretty(args) -> int:
    pretty_plugin.pretty_print(args.trace_dir, limit=args.n, name_filter=args.filter)
    return 0


def _timeline(args) -> int:
    n = timeline_plugin.write_timeline(args.trace_dir, args.out)
    print(f"[iprof] wrote {n} timeline events to {args.out} (open in ui.perfetto.dev)")
    return 0


def _validate(args) -> int:
    findings = validate_plugin.validate_trace(args.trace_dir)
    print(validate_plugin.render(findings))
    return 0 if not any(f.severity == "error" for f in findings) else 2


def _live(args) -> int:
    """``serve`` and ``top`` need the streaming masters (``core/stream.py``)."""
    raise NotImplementedError(
        f"iprof {args.cmd} is ported in a later slice "
        "(ROADMAP.md, modules to port: item 2, live tracing)"
    )


def _combine(args) -> int:
    paths = find_aggregates(args.root)
    if not paths:
        print(f"[iprof] no .tally aggregates under {args.root}", file=sys.stderr)
        return 1
    t = combine_aggregates(paths, fanout=args.fanout)
    print(tally_plugin.render(t))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="iprof", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="launch a traced entry point")
    r.add_argument("-m", "--mode", choices=MODES, default="default")
    r.add_argument(
        "--fidelity",
        choices=FIDELITY_MODES,
        default="full",
        help="fidelity ladder rung: full records everything enabled, sampled "
        "keeps 1/N of entry/exit pairs (tallies report unbiased ~estimates), "
        "tally-only folds in-process without writing streams, off disables "
        "collection (repro_torch.trace.set_mode can move the run mid-flight)",
    )
    r.add_argument(
        "--sampling-interval",
        type=int,
        default=64,
        metavar="N",
        help="keep 1 of every N entry/exit pairs on the sampled rung",
    )
    r.add_argument(
        "--sampling-seed",
        type=int,
        default=None,
        help="seed the per-thread sampling phase for reproducible sampled runs",
    )
    r.add_argument("--sample", action="store_true", help="enable device telemetry (§3.5)")
    r.add_argument("--sample-period", type=float, default=0.05)
    r.add_argument("-o", "--out", required=True)
    r.add_argument("--aggregate-only", action="store_true", help="§3.7 aggregate-only mode")
    r.add_argument("--rank", type=int, default=0)
    r.add_argument("--ranks", default=None, help="comma-separated ranks to trace (§3.2)")
    r.add_argument("--online", action="store_true", help="live tally on the consumer (§6)")
    r.add_argument(
        "--stream-to",
        default=None,
        help="push live snapshots to a master at host:port (not ported yet)",
    )
    r.add_argument(
        "--serve-port",
        type=int,
        default=None,
        help="serve this process's live tally on a local master port (not ported yet)",
    )
    r.add_argument(
        "--columnar",
        action="store_true",
        help="also write per-stream .ctfcol columnar sidecars at drain time "
        "(tally/timeline reads skip record parsing)",
    )
    r.add_argument(
        "--no-ring-reserve",
        action="store_true",
        help="recorders use the legacy bytes-build + ring write path instead "
        "of the zero-allocation reserve/commit pack_into codegen",
    )
    r.add_argument("entry", help="pkg.module:function")
    r.add_argument("args", nargs="*")
    r.set_defaults(fn=_run)

    t = sub.add_parser("tally", help="summary table (§4.3)")
    t.add_argument("trace_dir")
    t.add_argument("--top", type=int, default=None)
    t.add_argument("--device", action="store_true")
    t.add_argument(
        "--legacy-graph",
        action="store_true",
        help="tally via the full Babeltrace-style graph instead of the "
        "single-pass fold engine (slow; identical result)",
    )
    t.add_argument(
        "--jobs",
        type=int,
        default=1,
        help="shard the fold across N worker processes (0 = one per CPU); "
        "identical result for every N",
    )
    t.add_argument(
        "--no-sidecar",
        action="store_true",
        help="ignore .ctfcol columnar sidecars; always parse records",
    )
    t.set_defaults(fn=_tally)

    ix = sub.add_parser(
        "index", help="build columnar .ctfcol sidecars for an existing trace"
    )
    ix.add_argument("trace_dir")
    ix.set_defaults(fn=_index)

    pr = sub.add_parser("pretty", help="pretty-print events (§3.4)")
    pr.add_argument("trace_dir")
    pr.add_argument("-n", type=int, default=None)
    pr.add_argument("--filter", default=None)
    pr.set_defaults(fn=_pretty)

    tl = sub.add_parser("timeline", help="Perfetto timeline export (§3.6)")
    tl.add_argument("trace_dir")
    tl.add_argument("-o", "--out", default="timeline.json")
    tl.set_defaults(fn=_timeline)

    v = sub.add_parser("validate", help="post-mortem validation (§4.2)")
    v.add_argument("trace_dir")
    v.set_defaults(fn=_validate)

    c = sub.add_parser("combine", help="merge rank aggregates (§3.7)")
    c.add_argument("root")
    c.add_argument("--fanout", type=int, default=32)
    c.set_defaults(fn=_combine)

    for name, what in (
        ("serve", "run a streaming aggregation master (§3.7+§6; not ported yet)"),
        ("top", "attach to a master and render the live composite (not ported yet)"),
    ):
        sub.add_parser(name, help=what).set_defaults(fn=_live)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and args.fn is not _live:  # serve/top take their options unparsed
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
