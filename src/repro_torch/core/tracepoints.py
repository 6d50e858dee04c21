"""Automatic tracepoint generation (THAPI §3.3, Fig 1b, Fig 3).

THAPI generates the LTTng ``TRACEPOINT_EVENT`` C code and the interception
wrappers from the API model.  We do exactly that, in Python: for every event
type of the trace model we *generate source code* for

  * a **recorder** — the tracepoint: packs the payload per the event schema
    and writes one framed record into the calling thread's ring buffer;
  * an **unpacker** — the inverse, used by the Babeltrace-style analysis
    layer (and by Metababel's generated dispatchers), guaranteeing that the
    write and read sides can never drift apart because they come from the
    same schema;
  * a **pair recorder** for every entry/exit API — one call that frames both
    records in a single reserved region (the wrapper supplies the entry
    timestamp it captured before the traced work ran).

Two code variants are compiled per recorder and swapped via ``__code__`` at
session attach (so callables cached by the interception layer stay valid):

``ring_reserve=True`` (default) — the zero-allocation hot path.  The record
layout is compiled into fused ``struct`` formats (header + fixed fields +
varlen length prefixes collapse into ONE ``pack_into`` per contiguous run)
written directly into ring storage through the reserve/commit protocol.  The
per-thread ``(ring, storage, mask)`` binding is cached after first touch at
``_tls.c`` — one attribute load on the session registry's thread-local, no
registry/holder call chain — and the single-compare ``_lim`` bound skips
even the ``reserve()`` call on the common path.  Runtime helpers ride in
trailing positional defaults (LOAD_FAST, not LOAD_GLOBAL); session-scoped
ones (``_tls``) are refreshed through ``fn.__defaults__`` at attach.  The
generated fast path looks like:

    def ust_jaxrt__memcpy_entry(src, dst, nbytes, kind, payload_head,
                                _e=..., _bytes=..., _len=..., _tls=..., _bind=..., _now=..., _pk0=...):
        if not _e[7]: return
        _v0 = payload_head if payload_head.__class__ is _bytes else ...
        _k0 = _len(_v0)
        _n = 43 + _k0
        try:
            _ct = _tls.c
        except AttributeError:
            _ct = _bind()          # first touch: bind this thread's ring
        _rb = _ct[0]; _h = _rb.head
        if _h + _n <= _rb._lim:
            _pk0(_ct[1], _h & _ct[2], _n, 7, _now(), src, dst, nbytes, kind, _k0)
            ...
            _rb.head = _h + _n

``ring_reserve=False`` — the legacy bytes-write escape hatch: per-segment
``_S.pack`` objects concatenated and handed to ``RingBuffer.write``.  Both
variants produce byte-identical ring content for the same inputs and clock.

Per-event enablement (`_enabled`, a flat list of ints) is LTTng's selective
event activation (§3.2): the tracer flips entries per tracing mode; with no
active session every entry is 0 and tracepoints cost one list index + branch.
"""

from __future__ import annotations

import random
import struct
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .api_model import FIELD_CLASSES, VARLEN, EventType, TraceModel
from .clock import now
from .ringbuffer import RECORD_HEADER, RECORD_HEADER_SIZE, RingRegistry

_LEN = struct.Struct("<I")

#: the fidelity ladder (instrumentation-mode axis, orthogonal to the §5.2
#: *content* modes minimal/default/full): how much each tracepoint costs.
#:   full       — every enabled event is recorded (the historical behavior)
#:   sampled    — 1/N systematic sampling of entry/exit *pairs* (uniform
#:                random initial phase → exactly unbiased scaled estimates)
#:   tally-only — record as usual, but the consumer folds in-process and no
#:                .ctf stream is ever written (tracer.py's drain policy)
#:   off        — every enablement flag is zeroed in place: recorders cost
#:                one list index + branch, rings see zero writes
FIDELITY_MODES = ("full", "sampled", "tally-only", "off")

#: cap on the per-pair sampling-decision stacks: entries recorded without a
#: matching exit (or across a mid-run fidelity flip) must not grow the
#: per-thread state without bound.  Deeper nesting than this of one API on
#: one thread is degenerate; beyond it exits fall back to "record".
_SAMPLE_STACK_MAX = 1024


def _segments(fields) -> List:
    """Split the field tuple into runs of fixed-size fields and varlen fields.

    Returns a list of ("fixed", [Param...], struct.Struct) / ("var", Param).
    """
    segs: List = []
    run = []
    for f in fields:
        if f.cls in VARLEN:
            if run:
                segs.append(("fixed", list(run)))
                run = []
            segs.append(("var", f))
        else:
            run.append(f)
    if run:
        segs.append(("fixed", list(run)))
    out = []
    for seg in segs:
        if seg[0] == "fixed":
            fmt = "<" + "".join(FIELD_CLASSES[p.cls] for p in seg[1])
            out.append(("fixed", seg[1], struct.Struct(fmt)))
        else:
            out.append(seg)
    return out


# ---------------------------------------------------------------------------
# Reserve-mode codegen: record layout → fused pack_into program
# ---------------------------------------------------------------------------


class _RecordPlan:
    """One record of a recorder (a pair recorder has two)."""

    def __init__(self, ev: EventType, ts_expr: str, arg_prefix: str = ""):
        self.ev = ev
        self.ts_expr = ts_expr  # python expr for the header timestamp
        self.arg_prefix = arg_prefix  # disambiguates pair exit args
        self.segs = _segments(ev.fields)
        self.const = RECORD_HEADER_SIZE + sum(
            seg[2].size if seg[0] == "fixed" else 4 for seg in self.segs
        )
        self.kterms: List[str] = []  # filled by the walker

    def arg(self, p) -> str:
        return self.arg_prefix + p.name

    @property
    def size_expr(self) -> str:
        return " + ".join([str(self.const)] + self.kterms)


def _compile_records(records: List[_RecordPlan]):
    """Lay out one or more framed records into a fused pack_into program.

    Returns (prologue, ops, fmts, total_const, total_kterms, mega_vals).
    ``ops`` interleaves ("pack", fmt_idx, vals, off) and ("data", v, k, off)
    preserving byte order; ``off`` is (const, [k-terms]) relative to the
    reserved offset.  ``mega_vals`` is the all-varlens-empty value list for
    the single fused struct covering every byte (None when any group is
    impossible to fuse — i.e. never; it is None only when there is no varlen
    at all, in which case ``ops`` is already a single pack).
    """
    prologue: List[str] = []
    ops: List[tuple] = []
    fmts: List[str] = []
    mega_fmt = ""
    mega_vals: List[str] = []
    cur_fmt = ""
    cur_vals: List[str] = []
    cur_off: Optional[Tuple[int, List[str]]] = None
    const = 0
    terms: List[str] = []
    vidx = 0

    def flush():
        nonlocal cur_fmt, cur_vals, cur_off
        if cur_fmt:
            fmts.append("<" + cur_fmt)
            ops.append(("pack", len(fmts) - 1, cur_vals, cur_off))
        cur_fmt, cur_vals, cur_off = "", [], None

    def add(fmt: str, vals: List[str], mvals: List[str]):
        nonlocal cur_fmt, cur_off, mega_fmt
        if not cur_fmt:
            cur_off = (const, list(terms))
        cur_fmt += fmt
        cur_vals.extend(vals)
        mega_fmt += fmt
        mega_vals.extend(mvals)

    for rec in records:
        # precompute this record's own varlen terms (header needs its size)
        own = [f"_k{vidx + j}" for j, seg in enumerate(
            s for s in rec.segs if s[0] == "var")]
        rec.kterms = own
        add(
            "IHQ",
            [rec.size_expr, str(rec.ev.eid), rec.ts_expr],
            [str(rec.const), str(rec.ev.eid), rec.ts_expr],
        )
        const += RECORD_HEADER_SIZE
        for seg in rec.segs:
            if seg[0] == "fixed":
                _, params, st = seg
                names = [rec.arg(p) for p in params]
                add(st.format[1:], names, names)
                const += st.size
            else:
                _, p = seg
                v, k = f"_v{vidx}", f"_k{vidx}"
                name = rec.arg(p)
                if p.cls == "str":
                    prologue.append(
                        f"    {v} = {name}.encode() if {name}.__class__ is _str else _bytes({name})"
                    )
                else:
                    prologue.append(
                        f"    {v} = {name} if {name}.__class__ is _bytes else _bytes({name})"
                    )
                prologue.append(f"    {k} = _len({v})")
                add("I", [k], ["0"])
                const += 4
                flush()
                ops.append(("data", v, k, (const, list(terms))))
                terms.append(k)
                vidx += 1
    flush()
    if terms:
        fmts.append("<" + mega_fmt)
    else:
        mega_vals = None  # no varlen: the general program is one static pack
    return prologue, ops, fmts, const, terms, mega_vals


def _off_expr(off: Tuple[int, List[str]]) -> str:
    const, terms = off
    parts = ["_o"] + ([str(const)] if const else []) + terms
    return " + ".join(parts)


def _emit_pack_block(ops, indent: str) -> List[str]:
    lines = []
    for op in ops:
        if op[0] == "pack":
            _, idx, vals, off = op
            lines.append(f"{indent}_pk{idx}(_b, {_off_expr(off)}, {', '.join(vals)})")
        else:
            _, v, k, off = op
            lines.append(f"{indent}_s = {_off_expr(off)}")
            lines.append(f"{indent}_b[_s:_s + {k}] = {v}")
    return lines


def _reserve_body(
    records: List[_RecordPlan], nrecords: int, extra_drop: int
) -> Tuple[List[str], List[str], List[str]]:
    """Shared reserve-mode body (after the enablement check).

    Returns (lines, default_params, struct_formats).  ``extra_drop`` adds to
    ``dropped`` on a failed reserve beyond the 1 reserve() itself counts (a
    dropped pair discards two events).

    The per-thread binding ``(ring, storage, mask)`` lives at ``_tls.c``,
    where ``_tls`` is the *session registry's* ``threading.local`` (rebound
    into the recorder defaults at attach).  Thread-local storage dies with
    its thread, so a recycled thread ident can never alias a dead thread's
    ring, and every recorder shares the one binding per thread.
    """
    prologue, ops, fmts, const, terms, mega_vals = _compile_records(records)
    lines = list(prologue)
    lines.append(f"    _n = {' + '.join([str(const)] + terms)}")
    lines.append("    try:")
    lines.append("        _ct = _tls.c")
    lines.append("    except AttributeError:")
    lines.append("        _ct = _bind()")
    lines.append("    _rb = _ct[0]")
    lines.append("    _h = _rb.head")
    lines.append("    if _h + _n <= _rb._lim:")
    lines.append("        _b = _ct[1]")
    lines.append("        _o = _h & _ct[2]")
    if mega_vals is not None:
        mega_idx = len(fmts) - 1
        any_k = " or ".join(terms)
        lines.append(f"        if {any_k}:")
        lines.extend(_emit_pack_block(ops, " " * 12))
        lines.append("        else:")
        lines.append(
            f"            _pk{mega_idx}(_b, _o, {', '.join(mega_vals)})"
        )
    else:
        lines.extend(_emit_pack_block(ops, " " * 8))
    lines.append("        _rb.head = _h + _n")
    lines.append(f"        _rb.events += {nrecords}")
    lines.append("        return")
    lines.append("    _o = _rb.reserve(_n)")
    lines.append("    if _o < 0:")
    if extra_drop:
        lines.append(f"        _rb.dropped += {extra_drop}")
    lines.append("        return")
    lines.append("    _b = _rb.wbuf")
    lines.extend(_emit_pack_block(ops, "    "))
    lines.append("    _rb.commit(_n)")
    lines.append(f"    _rb.events += {nrecords}")

    # helpers ride in trailing positional defaults: LOAD_FAST, not LOAD_GLOBAL.
    # The flag lists are mutated in place by attach()/set_event (never
    # rebound), so binding the list object at def time is safe; `_tls` is
    # session state and gets refreshed via fn.__defaults__ at attach/detach.
    defaults = ["_e=_enabled"] if len(records) == 1 else ["_e2=_enabled2"]
    if terms:
        defaults.extend(["_bytes=_bytes", "_len=_len"])
        if any(
            seg[0] == "var" and seg[1].cls == "str"
            for rec in records
            for seg in rec.segs
        ):
            defaults.append("_str=_str")
    defaults.extend(["_tls=_tls", "_bind=_bind", "_now=_now"])
    defaults.extend(f"_pk{i}=_PK{i}" for i in range(len(fmts)))
    # sampling helpers ride in EVERY variant's defaults (used only by the
    # sampled codes): all four codes of one recorder share one parameter
    # list, so a fidelity flip is a single atomic __code__ store — no
    # __defaults__ rewrite racing concurrent callers
    defaults.extend(["_sn=_SN", "_qi=_QI"])
    return lines, defaults, fmts


def _sample_gate_lines(role: str, pair_idx: int) -> List[str]:
    """Systematic-sampling gate prepended to a recorder body (sampled tier).

    ``_q`` is the per-thread sampling state at ``_tls.q``: one list per
    entry/exit pair, ``_q[pair_idx][0]`` that pair's call counter
    (initialized to a uniform random phase in ``[0, N)`` by ``_qi``) and the
    remaining elements its decision stack, so an exit follows its own
    entry's decision under nesting.  Counters are *per pair*, not shared:
    each API keeps 1 of every N of *its own* calls, so periodic workloads
    (the common case — the same event sequence every step) cannot alias one
    API onto "always selected" and another onto "never selected"; every
    API's sampled count converges to calls/N.  The gate runs *before* the
    enablement check: the counter indexes call attempts, so entry singles,
    exit singles, and fused pair recorders stay mutually consistent
    regardless of per-event enablement overrides.
    """
    lines = [
        "    try:",
        "        _q = _tls.q",
        "    except AttributeError:",
        "        _q = _qi(_tls)",
        f"    _qp = _q[{pair_idx}]",
    ]
    if role == "pair":
        lines += [
            "    _c = _qp[0]",
            "    _qp[0] = _c + 1",
            "    if _c % _sn[0]: return",
        ]
    elif role == "entry":
        lines += [
            "    _c = _qp[0]",
            "    _qp[0] = _c + 1",
            "    _sel = 0 if _c % _sn[0] else 1",
            f"    if len(_qp) < {_SAMPLE_STACK_MAX}: _qp.append(_sel)",
            "    if not _sel: return",
        ]
    else:  # exit: follow the matching entry's decision; empty stack (entry
        # recorded before a flip into sampled mode) falls back to "record"
        lines += [
            "    if len(_qp) > 1 and not _qp.pop(): return",
        ]
    return lines


# ---------------------------------------------------------------------------
# Legacy codegen (the bytes-write escape hatch, ring_reserve=False)
# ---------------------------------------------------------------------------


def _legacy_payload_lines(
    ev: EventType, sname: str, pname: str, prefix: str = "", indent: str = "    "
) -> Tuple[List[str], str]:
    """Current-behavior payload build: per-segment packs + concatenation."""
    lines = []
    parts = []
    for i, seg in enumerate(_segments(ev.fields)):
        if seg[0] == "fixed":
            _, params, _ = seg
            argl = ", ".join(prefix + p.name for p in params)
            lines.append(f"{indent}{pname}{i} = {sname}{i}.pack({argl})")
        else:
            _, p = seg
            name = prefix + p.name
            if p.cls == "str":
                lines.append(
                    f"{indent}_lv{pname}{i} = {name}.encode() if type({name}) is str else bytes({name})"
                )
            else:
                lines.append(f"{indent}_lv{pname}{i} = bytes({name})")
            lines.append(f"{indent}{pname}{i} = _L.pack(len(_lv{pname}{i})) + _lv{pname}{i}")
        parts.append(f"{pname}{i}")
    payload = " + ".join(parts) if parts else "b''"
    return lines, payload


# ---------------------------------------------------------------------------
# Recorder codegen (both variants)
# ---------------------------------------------------------------------------


def codegen_recorder(
    ev: EventType,
    reserve: bool = True,
    sampled_pair: Optional[Tuple[int, str]] = None,
) -> str:
    """Source for one tracepoint function (≙ one TRACEPOINT_EVENT of Fig 3).

    ``sampled_pair=(pair_idx, role)`` emits the statistical-sampling variant:
    the systematic 1/N gate of :func:`_sample_gate_lines` runs first, then
    the normal enablement check and record body.
    """
    args = [p.name for p in ev.fields]
    fname = ev.name.replace(":", "__")
    gate = (
        _sample_gate_lines(sampled_pair[1], sampled_pair[0]) if sampled_pair else []
    )
    if reserve:
        body, defaults, _ = _reserve_body(
            [_RecordPlan(ev, "_now()")], nrecords=1, extra_drop=0
        )
        sig = ", ".join(args + defaults)
        lines = [f"def {fname}({sig}):"]
        lines.extend(gate)
        lines.append(f"    if not _e[{ev.eid}]: return")
        lines.extend(body)
        return "\n".join(lines)
    # legacy: identical behavior to the historical bytes-write recorder, with
    # the reserve variant's signature so __code__ swapping stays legal
    _, defaults, _ = _reserve_body([_RecordPlan(ev, "_now()")], 1, 0)
    sig = ", ".join(args + defaults)
    lines = [f"def {fname}({sig}):"]
    lines.extend(gate)
    lines.append(f"    if not _enabled[{ev.eid}]: return")
    pay_lines, payload = _legacy_payload_lines(ev, "_S", "_p")
    lines.extend(pay_lines)
    lines.append(f"    _p = {payload}")
    lines.append(
        f"    _rings.get().write(_H.pack({RECORD_HEADER_SIZE} + len(_p), {ev.eid}, _now()) + _p)"
    )
    return "\n".join(lines)


def codegen_pair_recorder(
    entry_ev: EventType,
    exit_ev: EventType,
    pair_idx: int,
    reserve: bool = True,
    sampled: bool = False,
) -> str:
    """Source for a fused entry/exit recorder: two framed records, one call.

    Signature: ``(<entry args>, _ts_entry, <exit args prefixed x_>)`` — the
    wrapper captures the entry timestamp before the traced work and records
    both events after it, halving the per-call overhead of the hottest
    interception pattern (the paper's memcpy running example; polling fences).
    The pair is atomic under discard: both records or neither (``dropped``
    advances by 2).  Enablement is one precomputed flag (``_enabled2``,
    maintained at attach/set_event); when overrides split the pair, a
    still-enabled entry is written with the caller's ``_ts_entry`` (not a
    fresh clock read — its timestamp must not shift because the *other*
    event of the pair was disabled) and a still-enabled exit goes through
    its single recorder.
    """
    e_args = [p.name for p in entry_ev.fields]
    x_args = ["x_" + p.name for p in exit_ev.fields]
    fname = entry_ev.name.replace(":", "__").replace("_entry", "_pair")
    gate = _sample_gate_lines("pair", pair_idx) if sampled else []

    def fallback(flag_expr):
        fa_lines, fa_payload = _legacy_payload_lines(
            entry_ev, "_SA", "_fa", indent=" " * 12
        )
        return [
            f"    if not {flag_expr}:",
            f"        if _enabled[{entry_ev.eid}]:",
            *fa_lines,
            f"            _fa = {fa_payload}",
            f"            _rings.get().write(_H.pack({RECORD_HEADER_SIZE} + len(_fa), "
            f"{entry_ev.eid}, _ts_entry) + _fa)",
            f"        if _enabled[{exit_ev.eid}]: _rec_exit({', '.join(x_args)})",
            "        return",
        ]

    records = [
        _RecordPlan(entry_ev, "_ts_entry"),
        _RecordPlan(exit_ev, "_now()", arg_prefix="x_"),
    ]
    if reserve:
        body, defaults, _ = _reserve_body(records, nrecords=2, extra_drop=1)
        sig = ", ".join(e_args + ["_ts_entry"] + x_args + defaults)
        lines = [f"def {fname}({sig}):"]
        lines.extend(gate)
        lines.extend(fallback(f"_e2[{pair_idx}]"))
        lines.extend(body)
        return "\n".join(lines)
    _, defaults, _ = _reserve_body(records, 2, 1)
    sig = ", ".join(e_args + ["_ts_entry"] + x_args + defaults)
    lines = [f"def {fname}({sig}):"]
    lines.extend(gate)
    lines.extend(fallback(f"_enabled2[{pair_idx}]"))
    pay_a, payload_a = _legacy_payload_lines(entry_ev, "_SA", "_pa")
    lines.extend(pay_a)
    lines.append(f"    _pa = {payload_a}")
    lines.append(
        f"    _r1 = _H.pack({RECORD_HEADER_SIZE} + len(_pa), {entry_ev.eid}, _ts_entry) + _pa"
    )
    pay_b, payload_b = _legacy_payload_lines(exit_ev, "_SB", "_pb", prefix="x_")
    lines.extend(pay_b)
    lines.append(f"    _pb = {payload_b}")
    lines.append(
        f"    _r2 = _H.pack({RECORD_HEADER_SIZE} + len(_pb), {exit_ev.eid}, _now()) + _pb"
    )
    lines.append("    _rb = _rings.get()")
    lines.append("    if len(_r1) + len(_r2) > _rb.capacity - (_rb.head - _rb.tail):")
    lines.append("        _rb.dropped += 2")
    lines.append("        return")
    lines.append("    _rb.write(_r1)")
    lines.append("    _rb.write(_r2)")
    return "\n".join(lines)


def codegen_unpacker(ev: EventType) -> str:
    """Source for the payload unpacker (field-order tuple from a memoryview)."""
    fname = "unpack_" + ev.name.replace(":", "__")
    lines = [f"def {fname}(mv):", "    _o = 0", "    _out = []"]
    for i, seg in enumerate(_segments(ev.fields)):
        if seg[0] == "fixed":
            _, params, st = seg
            lines.append(f"    _out.extend(_S{i}.unpack_from(mv, _o)); _o += {st.size}")
        else:
            _, p = seg
            lines.append("    _n = _L.unpack_from(mv, _o)[0]; _o += 4")
            if p.cls == "str":
                lines.append("    _out.append(bytes(mv[_o:_o+_n]).decode(errors='replace')); _o += _n")
            else:
                lines.append("    _out.append(bytes(mv[_o:_o+_n])); _o += _n")
    lines.append("    return tuple(_out)")
    return "\n".join(lines)


class Tracepoints:
    """All generated recorders/unpackers for one trace model.

    ``record[name]``       — tracepoint callables keyed by event name.
    ``record_pair[api]``   — fused entry/exit recorders keyed "provider:api".
    ``unpack[eid]``        — payload unpackers keyed by event id.
    ``enabled``            — per-event activation flags (shared with recorders).
    ``clock``              — timestamp source (injectable for byte-identity
                             tests; defaults to the trace clock).
    """

    def __init__(self, model: TraceModel, clock: Optional[Callable[[], int]] = None):
        self.model = model
        self.enabled: List[int] = [0] * len(model.events)
        #: the session's *wanted* enablement, as handed to attach()/set_event:
        #: the source of truth that "off" zeroes `enabled` against and that
        #: leaving "off" restores from
        self._session_enabled: List[int] = [0] * len(model.events)
        #: derived per-pair flags: enabled[entry] & enabled[exit], so the
        #: fused recorders pay one list index instead of two
        self.enabled_pair: List[int] = []
        self._pair_eids: List[Tuple[int, int]] = []
        self.clock = clock or now
        self.ring_reserve = True
        #: current rung of the fidelity ladder (see FIDELITY_MODES)
        self.fidelity = "full"
        self._sampled = False
        #: 1/N sampling interval, in a one-element list so the live value is
        #: readable through the recorders' `_sn` default without a rebind
        self._sample_interval: List[int] = [64]
        self._sample_rng = random.Random()
        #: forced initial counter phase (tests/ensemble enumeration); None
        #: draws uniformly from [0, N) per thread — the unbiasedness source
        self._sample_phase: Optional[int] = None
        self._qinit = self._make_qinit()
        self._registry_holder = _RegistryHolder()
        self._binder = self._make_binder(self._registry_holder)
        self.record: Dict[str, Callable] = {}
        self.record_pair: Dict[str, Callable] = {}
        self.unpack: Dict[int, Callable] = {}
        self._namespaces: List[dict] = []
        #: recorder → ((sampled, reserve) → code, ns, default names); attach()
        #: picks a code and refreshes __defaults__ from ns, set_fidelity()
        #: swaps codes alone (one atomic store per recorder)
        self._variants: Dict[Callable, Tuple] = {}

        # entry/exit pairing must precede single-recorder codegen: the
        # sampled variants of entry/exit singles address their pair's
        # decision stack by pair index
        by_key: Dict[Tuple[str, str], Dict[str, EventType]] = {}
        for ev in model.events:
            if ev.phase in ("entry", "exit"):
                by_key.setdefault((ev.provider, ev.api), {})[ev.phase] = ev
        pair_role: Dict[int, Tuple[int, str]] = {}  # eid → (pair_idx, role)
        for (provider, api), phases in by_key.items():
            if "entry" not in phases or "exit" not in phases:
                continue
            pair_idx = len(self._pair_eids)
            self._pair_eids.append((phases["entry"].eid, phases["exit"].eid))
            self.enabled_pair.append(0)
            pair_role[phases["entry"].eid] = (pair_idx, "entry")
            pair_role[phases["exit"].eid] = (pair_idx, "exit")

        for ev in model.events:
            ns = self._base_ns()
            for i, seg in enumerate(_segments(ev.fields)):
                if seg[0] == "fixed":
                    ns[f"_S{i}"] = seg[2]
            names = self._install_structs(ns, [_RecordPlan(ev, "_now()")], 1, 0)
            sp = pair_role.get(ev.eid)
            sources = [
                ((False, True), codegen_recorder(ev, reserve=True)),
                ((False, False), codegen_recorder(ev, reserve=False)),
            ]
            if sp is not None:  # only entry/exit pairs get a sampled tier
                sources += [
                    ((True, True), codegen_recorder(ev, reserve=True, sampled_pair=sp)),
                    ((True, False), codegen_recorder(ev, reserve=False, sampled_pair=sp)),
                ]
            fn = self._compile_variants(
                ns, ev.name.replace(":", "__"), sources, ev.name, names
            )
            self.record[ev.name] = fn

            uns = {"_L": _LEN}
            for i, seg in enumerate(_segments(ev.fields)):
                if seg[0] == "fixed":
                    uns[f"_S{i}"] = seg[2]
            usrc = codegen_unpacker(ev)
            exec(compile(usrc, f"<unpacker {ev.name}>", "exec"), uns)
            self.unpack[ev.eid] = uns["unpack_" + ev.name.replace(":", "__")]

        # fused entry/exit pair recorders (same pair order as the precompute)
        for (provider, api), phases in by_key.items():
            if "entry" not in phases or "exit" not in phases:
                continue
            entry_ev, exit_ev = phases["entry"], phases["exit"]
            pair_idx = pair_role[entry_ev.eid][0]
            ns = self._base_ns()
            for i, seg in enumerate(_segments(entry_ev.fields)):
                if seg[0] == "fixed":
                    ns[f"_SA{i}"] = seg[2]
            for i, seg in enumerate(_segments(exit_ev.fields)):
                if seg[0] == "fixed":
                    ns[f"_SB{i}"] = seg[2]
            ns["_rec_entry"] = self.record[entry_ev.name]
            ns["_rec_exit"] = self.record[exit_ev.name]
            records = [
                _RecordPlan(entry_ev, "_ts_entry"),
                _RecordPlan(exit_ev, "_now()", arg_prefix="x_"),
            ]
            names = self._install_structs(ns, records, 2, 1)
            sources = [
                ((False, True), codegen_pair_recorder(entry_ev, exit_ev, pair_idx, reserve=True)),
                ((False, False), codegen_pair_recorder(entry_ev, exit_ev, pair_idx, reserve=False)),
                ((True, True), codegen_pair_recorder(entry_ev, exit_ev, pair_idx, reserve=True, sampled=True)),
                ((True, False), codegen_pair_recorder(entry_ev, exit_ev, pair_idx, reserve=False, sampled=True)),
            ]
            fn = self._compile_variants(
                ns,
                entry_ev.name.replace(":", "__").replace("_entry", "_pair"),
                sources,
                f"{provider}:{api}",
                names,
            )
            self.record_pair[f"{provider}:{api}"] = fn

    # -- codegen plumbing ----------------------------------------------------

    def _base_ns(self) -> dict:
        ns = {
            "_enabled": self.enabled,
            "_enabled2": self.enabled_pair,
            "_rings": self._registry_holder,
            "_H": RECORD_HEADER,
            "_L": _LEN,
            "_now": self.clock,
            "_bytes": bytes,
            "_len": len,
            "_str": str,
            # per-thread ring-binding cache lives at _tls.c; a placeholder
            # local until a session attaches its registry's thread-local.
            # Per-THREAD storage (not ident-keyed): a recycled thread ident
            # can never alias a dead thread's binding.
            "_tls": threading.local(),
            "_bind": self._binder,
            "_SN": self._sample_interval,
            "_QI": self._qinit,
        }
        self._namespaces.append(ns)
        return ns

    def _make_qinit(self) -> Callable:
        """Cold-path sampling-state init: build this thread's ``_tls.q`` —
        one ``[counter, *decision_stack]`` list per entry/exit pair, each
        counter starting at a (random or forced) phase in ``[0, N)``.
        Random phases are drawn independently per pair; a forced phase
        (tests enumerating the ensemble) applies to every pair."""

        def qinit(tls):
            n = self._sample_interval[0]
            ph = self._sample_phase
            q: list = []
            for _ in range(len(self._pair_eids)):
                if ph is not None:
                    p = ph
                else:
                    p = self._sample_rng.randrange(n) if n > 1 else 0
                q.append([p])
            tls.q = q
            return q

        return qinit

    @staticmethod
    def _make_binder(holder) -> Callable:
        """Cold-path ring binding: resolve this thread's ring once, cache the
        ``(ring, storage, mask)`` tuple on the session registry's
        thread-local — all recorders share it via their ``_tls`` default."""

        def bind():
            registry = holder.registry
            rb = registry.get()
            ct = (rb, rb._buf, rb._mask)
            registry._tls.c = ct
            return ct

        return bind

    @staticmethod
    def _install_structs(ns: dict, records: List[_RecordPlan], nrec: int, extra: int) -> List[str]:
        """Bind the fused pack_into methods the reserve variant's defaults
        use; return the defaults' namespace names (for __defaults__ refresh)."""
        _, defaults, fmts = _reserve_body(records, nrec, extra)
        for i, fmt in enumerate(fmts):
            ns[f"_PK{i}"] = struct.Struct(fmt).pack_into
        return [d.split("=", 1)[1] for d in defaults]

    def _compile_variants(self, ns, pyname, sources, label, default_names):
        """Compile every (sampled, reserve) source into one namespace; the
        first source's function object is the installed callable, the rest
        contribute only their code objects.  Recorders with no sampled tier
        (spans, counters, samples) alias the full codes — a fidelity flip
        still swaps them, to the code they already run."""
        codes: Dict[Tuple[bool, bool], object] = {}
        fn = None
        for key, src in sources:
            tag = f"{'sampled ' if key[0] else ''}{'reserve' if key[1] else 'legacy'}"
            exec(compile(src, f"<tracepoint {tag} {label}>", "exec"), ns)
            f = ns.pop(pyname)
            if fn is None:
                fn = f
            codes[key] = f.__code__
        for r in (True, False):
            codes.setdefault((True, r), codes[(False, r)])
        ns[pyname] = fn
        self._variants[fn] = (codes, ns, default_names)
        return fn

    # -- session binding -----------------------------------------------------

    def _rebind_session(self, tls) -> None:
        """Point every recorder's ``_tls`` default at the session's
        thread-local.  A fresh local has no ``c`` attribute anywhere, so all
        threads fall to the bind path on first touch — cache invalidation
        across sessions comes for free (the sampling state ``_tls.q`` rides
        the same object and is invalidated the same way)."""
        key = (self._sampled, self.ring_reserve)
        for fn, (codes, ns, names) in self._variants.items():
            ns["_tls"] = tls
            code = codes[key]
            if fn.__code__ is not code:
                fn.__code__ = code
            fn.__defaults__ = tuple(ns[n] for n in names)

    def _swap_codes(self) -> None:
        """Flip every recorder to the current (sampled, reserve) code.

        The mode-switch handoff invariant: all variants of one recorder share
        one parameter list and one defaults tuple, so this is a single atomic
        ``__code__`` store per recorder under the GIL — a concurrent caller
        runs either the old or the new code in full, and both publish whole
        framed records (pack first, then one atomic ``head`` store), so no
        torn or reordered records can exist across the flip.
        """
        key = (self._sampled, self.ring_reserve)
        for fn, (codes, _ns, _names) in self._variants.items():
            code = codes[key]
            if fn.__code__ is not code:
                fn.__code__ = code

    def attach(
        self,
        registry: RingRegistry,
        enabled_eids: Sequence[int],
        ring_reserve: bool = True,
    ) -> None:
        self._registry_holder.registry = registry
        self.ring_reserve = bool(ring_reserve)
        self.fidelity = "full"  # every session starts at the top rung
        self._sampled = False
        self._rebind_session(registry._tls)
        for eid in range(len(self.enabled)):
            self.enabled[eid] = 0
            self._session_enabled[eid] = 0
        for eid in enabled_eids:
            self.enabled[eid] = 1
            self._session_enabled[eid] = 1
        self._recompute_pairs()

    def detach(self) -> None:
        for eid in range(len(self.enabled)):
            self.enabled[eid] = 0
            self._session_enabled[eid] = 0
        self.fidelity = "full"
        self._sampled = False
        self._recompute_pairs()
        self._rebind_session(threading.local())  # drop all ring bindings
        self._registry_holder.registry = None

    def set_event(self, name: str, on: bool) -> None:
        ev = self.model.by_name()[name]
        self._session_enabled[ev.eid] = 1 if on else 0
        if self.fidelity != "off":  # "off" keeps the live flags zeroed
            self.enabled[ev.eid] = 1 if on else 0
        self._recompute_pairs()

    def set_fidelity(
        self,
        mode: str,
        interval: Optional[int] = None,
        phase: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> str:
        """Move to a rung of the fidelity ladder; returns the previous rung.

        ``interval`` updates the 1/N sampling interval (in place: already
        bound threads see it on their next draw).  ``phase`` forces the
        per-thread initial counter phase (tests enumerate the ensemble with
        it); ``seed`` reseeds the phase RNG.  Safe mid-run: see _swap_codes.
        """
        if mode not in FIDELITY_MODES:
            raise ValueError(f"unknown fidelity {mode!r} (want one of {FIDELITY_MODES})")
        if interval is not None:
            if int(interval) < 1:
                raise ValueError("sampling interval must be >= 1")
            self._sample_interval[0] = int(interval)
        if seed is not None:
            self._sample_rng = random.Random(seed)
        self._sample_phase = phase
        prev = self.fidelity
        self.fidelity = mode
        want_sampled = mode == "sampled"
        if want_sampled != self._sampled:
            self._sampled = want_sampled
            self._swap_codes()
        if mode == "off":
            for eid in range(len(self.enabled)):
                self.enabled[eid] = 0
        else:
            for eid in range(len(self.enabled)):
                self.enabled[eid] = self._session_enabled[eid]
        self._recompute_pairs()
        return prev

    def _recompute_pairs(self) -> None:
        enabled = self.enabled
        for i, (e, x) in enumerate(self._pair_eids):
            self.enabled_pair[i] = enabled[e] & enabled[x]


class _RegistryHolder:
    """Indirection cell so generated code survives session swaps.

    ``get()`` raises only if a recorder fires while enabled[eid]==1 but no
    registry is attached — a tracer bug, not a user state.
    """

    __slots__ = ("registry",)

    def __init__(self):
        self.registry: Optional[RingRegistry] = None

    def get(self):
        return self.registry.get()
