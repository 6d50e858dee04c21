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
    python -m repro_torch.core.iprof serve --port 9000        # streaming master (§3.7+§6)
    python -m repro_torch.core.iprof top   127.0.0.1:9000 [--live] [--by-rank]  # live composite view
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
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
        stream_period_s=args.stream_period,
        stream_delta=not args.no_stream_delta,
        stream_resync_every=args.stream_resync_every,
        serve_port=args.serve_port,
        ring_reserve=not args.no_ring_reserve,
        columnar=args.columnar,
        fidelity=args.fidelity,
        sampling_interval=args.sampling_interval,
        sampling_seed=args.sampling_seed,
        stream_token=args.token,
        stream_tls_ca=args.tls_ca,
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
    if args.stream_to:
        line += f" streamed={h.streamed} stream_dropped={h.stream_dropped}"
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


def _parse_tokens(specs) -> Optional[dict]:
    """``--token TOK[=TENANT]`` (repeatable) → {token: tenant} or None."""
    if not specs:
        return None
    tokens = {}
    for spec in specs:
        tok, sep, tenant = spec.partition("=")
        if not tok:
            raise ValueError(f"bad --token {spec!r}: empty token")
        tokens[tok] = tenant if sep and tenant else "default"
    return tokens


def _serve(args) -> int:
    """Run a streaming master (local when --forward-to, else global)."""
    from .stream import MasterServer, ServeOptions

    rollup = args.rollup_groups
    if rollup is not None:
        if rollup.isdigit() and int(rollup) > 0:
            rollup = int(rollup)
        elif rollup != "host":
            print(
                f"[iprof] bad --rollup-groups {rollup!r}: want 'host' or a "
                "positive integer bucket size",
                file=sys.stderr,
            )
            return 2
    try:
        opts = ServeOptions(
            fanout=args.fanout,
            forward_ranks=not args.no_forward_ranks,
            rollup_groups=rollup,
            tls_cert=args.tls_cert,
            tls_key=args.tls_key,
            tls_ca=args.tls_ca,
            auth_tokens=_parse_tokens(args.token),
            max_sources=args.max_sources,
            max_tally_rows=args.max_tally_rows,
            max_subscribers=args.max_subscribers,
            forward_token=args.forward_token,
            forward_tls_ca=args.forward_tls_ca,
            source_ttl_s=args.source_ttl,
        )
    except ValueError as e:
        print(f"[iprof] bad serving options: {e}", file=sys.stderr)
        return 2
    try:
        m = MasterServer(
            port=args.port,
            host=args.bind,
            forward_to=args.forward_to,
            forward_period_s=args.forward_period,
            options=opts,
        ).start()
    except OSError as e:
        # covers bind errors and ssl.SSLError loading a bad cert/key pair
        print(f"[iprof] cannot start master on {args.bind}:{args.port}: {e}", file=sys.stderr)
        return 1
    role = f"local master → {args.forward_to}" if args.forward_to else "global master"
    hardened = []
    if opts.tls_cert:
        hardened.append("tls")
    if opts.auth_required:
        hardened.append(f"auth[{len(opts.auth_tokens)} token(s)]")
    suffix = f" ({', '.join(hardened)})" if hardened else ""
    print(f"[iprof] {role} listening on {m.addr}{suffix}", flush=True)
    try:
        if args.duration is not None:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        m.stop()
        st = m.stats()
        line = (
            f"[iprof] master stopped: {st['sources']} sources, "
            f"{st['snapshots']} snapshots ({st['deltas']} deltas, "
            f"{st['resyncs']} resyncs), {st['queries']} queries"
        )
        rejects = (
            st["auth_failures"]
            + st["tls_failures"]
            + st["quota_src_rejects"]
            + st["quota_row_rejects"]
            + st["quota_sub_rejects"]
        )
        if rejects:
            line += (
                f"; rejects: {st['auth_failures']} auth, {st['tls_failures']} tls, "
                f"{st['quota_src_rejects']}/{st['quota_row_rejects']}/"
                f"{st['quota_sub_rejects']} quota(src/row/sub), "
                f"{st['sub_evictions']} slow-subscriber evictions"
            )
        if st.get("fence_rejects") or st.get("source_gc"):
            line += (
                f"; elastic: {st.get('fence_rejects', 0)} fenced frames, "
                f"{st.get('source_gc', 0)} sources GC'd"
            )
        print(line)
    return 0


def _render_composite(args, t, meta, ranks=None, groups=None) -> None:
    """One `iprof top` refresh: header line + tally table(s)."""
    if not args.no_clear:
        print("\x1b[2J\x1b[H", end="")
    age = max(0.0, time.time() - meta["updated"]) if meta.get("updated") else 0.0
    print(
        f"[iprof top] {args.addr} | {meta.get('sources', 0)} sources | "
        f"{meta.get('snapshots', 0)} snapshots | updated {age:.1f}s ago"
    )
    print(tally_plugin.render(t, top=args.top, device=False))
    if args.device or t.device_apis:
        print("\n-- device --")
        print(tally_plugin.render(t, top=args.top, device=True))
    if ranks is not None:
        print("\n-- ranks --")
        print(
            tally_plugin.render_by_rank(
                ranks,
                top=args.top,
                device=args.device,
                incarnations=meta.get("incarnations"),
                retired=meta.get("retired"),
            )
        )
    if groups is not None:
        print("\n-- groups --")
        print(
            tally_plugin.render_by_rank(
                groups, top=args.top, device=args.device, label="Group"
            )
        )


def _top_live(args, client_kw) -> int:
    """``--live``: hold a subscription open, rendering pushed composites.

    Survives master restarts: on disconnect after a successful attach the
    loop reconnects with capped exponential backoff (starting at
    min(1s, --interval), doubling to --reconnect-max-wait) and re-subscribes
    on the fresh connection.  ``--no-reconnect`` restores one-shot semantics;
    a first connect that never succeeds is still rc-1 "unreachable".
    """
    from .stream import ProtocolError, ServerRejected, StreamClient

    shown = 0
    ever_connected = False
    wait = min(1.0, max(args.interval, 0.05))
    while True:
        try:
            with StreamClient(args.addr, timeout_s=args.timeout, **client_kw) as c:
                ever_connected = True
                for t, meta in c.subscribe(period_s=args.interval, by_rank=args.by_rank):
                    wait = min(1.0, max(args.interval, 0.05))  # healthy: reset backoff
                    _render_composite(args, t, meta, ranks=meta.get("ranks"))
                    shown += 1
                    if args.iterations is not None and shown >= args.iterations:
                        return 0
            # generator exhausted: master closed the stream cleanly
        except ServerRejected as e:
            print(f"[iprof] master at {args.addr} rejected us: {e}", file=sys.stderr)
            return 1
        except (OSError, ProtocolError) as e:
            if not ever_connected:
                print(f"[iprof] master at {args.addr} unreachable: {e}", file=sys.stderr)
                return 1
            if args.no_reconnect:
                print(f"[iprof] master at {args.addr} lost: {e}", file=sys.stderr)
                return 1
        if args.no_reconnect:
            return 0
        print(
            f"[iprof] lost master at {args.addr}; retrying in {wait:.1f}s",
            file=sys.stderr,
        )
        time.sleep(wait)
        wait = min(wait * 2, args.reconnect_max_wait)


def _top(args) -> int:
    """Attach to a master; render the live composite, refreshing.

    Default mode polls one reused query connection per refresh; ``--live``
    subscribes for pushed composites (the v2 ``subscribe`` frame) and
    reconnects across master restarts.  ``--by-rank`` appends the per-rank
    breakdown table — the straggler/skew view.
    """
    from .aggregate import merge_tallies
    from .stream import ProtocolError, ServerRejected, StreamClient

    if args.live and args.by_group:
        print(
            "[iprof] --by-group is poll-only; ignoring --live for this view",
            file=sys.stderr,
        )
    client_kw = {"token": args.token, "tls_ca": args.tls_ca}
    try:
        if args.live and not args.by_group:  # group view is poll-only
            return _top_live(args, client_kw)
        with StreamClient(args.addr, timeout_s=args.timeout, **client_kw) as c:
            i = 0
            while args.iterations is None or i < args.iterations:
                if i:
                    time.sleep(args.interval)
                i += 1
                if args.by_group:
                    groups, meta = c.groups()
                    if not meta.get("rollup"):
                        print(
                            f"[iprof] master at {args.addr} runs without "
                            "--rollup-groups; no group breakdown to show",
                            file=sys.stderr,
                        )
                        return 1
                    copies = [tally_plugin.Tally().merge(t) for t in groups.values()]
                    t = merge_tallies(copies)[0] if copies else tally_plugin.Tally()
                    _render_composite(args, t, meta, groups=groups)
                elif args.by_rank:
                    ranks, meta = c.ranks()
                    # merge_tallies folds in place: merge copies, keep ranks intact
                    copies = [tally_plugin.Tally().merge(t) for t in ranks.values()]
                    t = merge_tallies(copies)[0] if copies else tally_plugin.Tally()
                    _render_composite(args, t, meta, ranks=ranks)
                else:
                    t, meta = c.composite()
                    _render_composite(args, t, meta)
        return 0
    except ValueError:
        print(f"[iprof] bad master address {args.addr!r} (want host:port)", file=sys.stderr)
        return 2
    except ServerRejected as e:
        print(f"[iprof] master at {args.addr} rejected us: {e}", file=sys.stderr)
        return 1
    except (OSError, ProtocolError) as e:
        print(f"[iprof] master at {args.addr} unreachable: {e}", file=sys.stderr)
        return 1


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
        "--stream-to", default=None, help="push live snapshots to a master at host:port"
    )
    r.add_argument("--stream-period", type=float, default=0.25)
    r.add_argument(
        "--no-stream-delta",
        action="store_true",
        help="disable v2 delta frames: push full snapshots every period",
    )
    r.add_argument(
        "--stream-resync-every",
        type=int,
        default=32,
        help="full-snapshot resync frame every N delta pushes",
    )
    r.add_argument(
        "--token",
        default=None,
        help="auth token sent in the stream hello (masters started with --token)",
    )
    r.add_argument(
        "--tls-ca",
        default=None,
        metavar="PEM",
        help="connect to the master over TLS, trusting this CA/cert bundle",
    )
    r.add_argument(
        "--serve-port",
        type=int,
        default=None,
        help="serve this process's live tally on a local master port (iprof top attaches)",
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

    s = sub.add_parser("serve", help="run a streaming aggregation master (§3.7+§6)")
    s.add_argument("--port", type=int, default=9000, help="0 picks an ephemeral port")
    s.add_argument("--bind", default="127.0.0.1")
    s.add_argument(
        "--forward-to", default=None, help="parent master host:port (makes this a local master)"
    )
    s.add_argument("--forward-period", type=float, default=0.5)
    s.add_argument("--fanout", type=int, default=32)
    s.add_argument(
        "--duration", type=float, default=None, help="serve for N seconds then exit (default: forever)"
    )
    s.add_argument(
        "--no-forward-ranks",
        action="store_true",
        help="forward one merged composite upstream instead of the per-rank breakdown",
    )
    s.add_argument(
        "--rollup-groups",
        default=None,
        metavar="HOST|N",
        help="aggregate sources into node-level rollup groups on ingest: "
        "'host' groups by hostname, an integer N buckets ranks N-at-a-time "
        "(pre-aggregation for >1k-rank trees; query with iprof top --by-group)",
    )
    s.add_argument(
        "--tls-cert",
        default=None,
        metavar="PEM",
        help="serve over TLS with this certificate (chain) file",
    )
    s.add_argument(
        "--tls-key",
        default=None,
        metavar="PEM",
        help="private key for --tls-cert (default: key is in the cert file)",
    )
    s.add_argument(
        "--tls-ca",
        default=None,
        metavar="PEM",
        help="with --tls-cert: require and verify client certificates against "
        "this CA (mutual TLS); without it, also used as the CA for "
        "--forward-to upstream TLS",
    )
    s.add_argument(
        "--token",
        action="append",
        default=None,
        metavar="TOK[=TENANT]",
        help="require hello auth; repeatable — each token maps its clients "
        "into TENANT's namespace (default tenant when omitted)",
    )
    s.add_argument(
        "--max-sources",
        type=int,
        default=0,
        help="per-tenant source quota (0 = unlimited)",
    )
    s.add_argument(
        "--max-tally-rows",
        type=int,
        default=0,
        help="per-source tally-row quota, host+device (0 = unlimited)",
    )
    s.add_argument(
        "--max-subscribers",
        type=int,
        default=0,
        help="per-tenant live-subscriber quota (0 = unlimited)",
    )
    s.add_argument(
        "--source-ttl",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="garbage-collect sources with no frames for this long "
        "(0 = keep forever; evicted/dead ranks then linger in composites)",
    )
    s.add_argument(
        "--forward-token",
        default=None,
        help="auth token for the --forward-to upstream master",
    )
    s.add_argument(
        "--forward-tls-ca",
        default=None,
        metavar="PEM",
        help="connect to --forward-to over TLS, trusting this CA/cert bundle",
    )
    s.set_defaults(fn=_serve)

    tp = sub.add_parser("top", help="attach to a master and render the live composite")
    tp.add_argument("addr", help="master host:port")
    tp.add_argument(
        "--live",
        action="store_true",
        help="subscribe for pushed composite updates instead of polling queries",
    )
    tp.add_argument(
        "--by-rank",
        action="store_true",
        help="append the per-rank breakdown table (straggler/skew view)",
    )
    tp.add_argument(
        "--by-group",
        action="store_true",
        help="poll the rollup-group breakdown instead (masters started with "
        "--rollup-groups); node-granularity view of >1k-rank trees",
    )
    tp.add_argument("--interval", type=float, default=1.0)
    tp.add_argument(
        "--iterations", type=int, default=None, help="refresh N times then exit (default: forever)"
    )
    tp.add_argument("--timeout", type=float, default=3.0)
    tp.add_argument("--top", type=int, default=None)
    tp.add_argument("--device", action="store_true")
    tp.add_argument("--no-clear", action="store_true", help="don't clear the screen between refreshes")
    tp.add_argument(
        "--token", default=None, help="auth token (masters started with --token)"
    )
    tp.add_argument(
        "--tls-ca",
        default=None,
        metavar="PEM",
        help="connect over TLS, trusting this CA/cert bundle",
    )
    tp.add_argument(
        "--no-reconnect",
        action="store_true",
        help="--live: exit when the master goes away instead of reconnecting",
    )
    tp.add_argument(
        "--reconnect-max-wait",
        type=float,
        default=15.0,
        help="--live: cap for the exponential reconnect backoff (seconds)",
    )
    tp.set_defaults(fn=_top)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
