"""API models + meta-parameters (THAPI §3.3, Fig 1b, Fig 3).

THAPI parses API headers (CUDA/L0/HIP) or XML descriptions (OpenCL) into an
intermediary YAML *API model*, then enriches it with user-provided
*meta-parameters* (e.g. ``cuMemGetInfo: [[OutScalar, free], [OutScalar,
total]]``) that encode expert knowledge the headers cannot express: which
pointer args are inputs vs outputs, which APIs need device-profiling code,
which are polling/spin-lock APIs to exclude from the default mode.

Here the "headers" of our heterogeneous stack are Python call signatures and
declarative specs.  The same pipeline applies:

    declarative spec (this module)  ≙  header/XML parse → YAML API model
    Meta-parameters                 ≙  THAPI meta-parameters (Fig 3 bottom-left)
    build_trace_model()             ≙  API model → LTTng trace model (Fig 3 mid)
    tracepoints.generate_recorders  ≙  trace model → TRACEPOINT_EVENT codegen

Field classes map onto CTF integer/float/string classes with display hints
(pointers print base-16, exactly like the ``preferred_display_base: 16`` in
Fig 3).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Field classes (≙ CTF field classes). struct codes drive the codegen.
# ---------------------------------------------------------------------------

FIELD_CLASSES: Mapping[str, str] = {
    "u8": "B",
    "u16": "H",
    "u32": "I",
    "u64": "Q",
    "i32": "i",
    "i64": "q",
    "f32": "f",
    "f64": "d",
    "bool": "B",
    "ptr": "Q",  # preferred_display_base: 16
    # varlen classes (u32 length prefix), handled outside struct:
    "str": None,
    "bytes": None,
}

VARLEN = frozenset({"str", "bytes"})


@dataclasses.dataclass(frozen=True)
class Param:
    """One API parameter (≙ a ``params`` entry of the API model in Fig 3)."""

    name: str
    cls: str  # one of FIELD_CLASSES
    display_base: int = 10

    def __post_init__(self):
        if self.cls not in FIELD_CLASSES:
            raise ValueError(f"unknown field class {self.cls!r} for param {self.name!r}")

    def to_json(self) -> dict:
        return {"name": self.name, "class": self.cls, "display_base": self.display_base}


def P(name: str, cls: str) -> Param:
    """Shorthand constructor; pointers get base-16 display automatically."""
    return Param(name, cls, display_base=16 if cls == "ptr" else 10)


# ---------------------------------------------------------------------------
# Meta-parameters (THAPI Fig 3: expert knowledge the headers can't express).
# ---------------------------------------------------------------------------
#
#   OutScalar  — value produced by the call, recorded on the *exit* event
#                (cuMemGetInfo free/total in the paper's running example).
#   InScalar   — extra semantic input recorded on the *entry* event.
#   Profiled   — attach device-profiling code: the wrapper fences the device
#                and emits a span event with device start/end timestamps
#                (≙ "Cuda record entry/exit", "Level-Zero profiling" in Fig 2).
#   Polling    — spin-lock style API (zeEventHostSynchronize/cuQueryEvent
#                class): traced only in FULL mode (§5.2 "non-spawned APIs").
#   ArgDump    — serialize small argument buffers into the event payload
#                (full mode only; "values behind pointers", §1.1).

META_KINDS = ("OutScalar", "InScalar", "Profiled", "Polling", "ArgDump")


@dataclasses.dataclass(frozen=True)
class APISpec:
    """One traced API: entry/exit payload schema + meta-parameters."""

    name: str
    params: Tuple[Param, ...] = ()
    result: Optional[Param] = None
    meta: Tuple[Tuple[str, Param], ...] = ()  # (kind, param)
    span: bool = False  # device-span API: single event w/ start+end ts
    counter: bool = False  # telemetry counter: single sample event, no entry/exit

    def __post_init__(self):
        for kind, _ in self.meta:
            if kind not in META_KINDS:
                raise ValueError(f"unknown meta-parameter kind {kind!r} on {self.name}")

    # -- derived -----------------------------------------------------------
    @property
    def tags(self) -> frozenset:
        return frozenset(k for k, _ in self.meta)

    @property
    def is_polling(self) -> bool:
        return "Polling" in self.tags

    @property
    def is_profiled(self) -> bool:
        return "Profiled" in self.tags

    def entry_fields(self) -> Tuple[Param, ...]:
        extra = tuple(p for k, p in self.meta if k == "InScalar")
        return self.params + extra

    def exit_fields(self) -> Tuple[Param, ...]:
        out = tuple(p for k, p in self.meta if k == "OutScalar")
        res = (self.result,) if self.result is not None else ()
        return res + out

    def dump_fields(self) -> Tuple[Param, ...]:
        return tuple(p for k, p in self.meta if k == "ArgDump")


@dataclasses.dataclass(frozen=True)
class APIModel:
    """A programming-model description (≙ one YAML API model per backend)."""

    provider: str  # e.g. "ust_jaxrt" — ≙ lttng_ust_cuda domain prefix
    apis: Tuple[APISpec, ...]

    def by_name(self) -> Mapping[str, APISpec]:
        return {a.name: a for a in self.apis}


# ---------------------------------------------------------------------------
# Trace model (≙ the LTTng trace model of Fig 3, consumed by the codegen and
# by the Babeltrace-style analysis layer).
# ---------------------------------------------------------------------------

#: event id 0 is reserved for the CTF "discarded events" record the consumer
#: emits when it observes the ring-buffer drop counter advance (LTTng discard
#: mode, §3.1).
DISCARD_EVENT_ID = 0
DISCARD_EVENT_NAME = "ctf:events_discarded"


@dataclasses.dataclass(frozen=True)
class EventType:
    eid: int
    name: str  # "provider:api_entry" etc.
    provider: str
    api: str
    phase: str  # "entry" | "exit" | "span" | "sample" | "meta"
    fields: Tuple[Param, ...]
    polling: bool = False

    def to_json(self) -> dict:
        return {
            "eid": self.eid,
            "name": self.name,
            "provider": self.provider,
            "api": self.api,
            "phase": self.phase,
            "polling": self.polling,
            "fields": [f.to_json() for f in self.fields],
        }

    @staticmethod
    def from_json(d: dict) -> "EventType":
        return EventType(
            eid=int(d["eid"]),
            name=d["name"],
            provider=d["provider"],
            api=d["api"],
            phase=d["phase"],
            polling=bool(d.get("polling", False)),
            fields=tuple(
                Param(f["name"], f["class"], int(f.get("display_base", 10)))
                for f in d["fields"]
            ),
        )


@dataclasses.dataclass(frozen=True)
class TraceModel:
    """All event types of a session, id-indexed. Serialized into metadata.json
    so analysis tools are *generated from the trace model*, never hand-kept in
    sync (the paper's maintainability argument, §3.3 summary)."""

    events: Tuple[EventType, ...]

    def __post_init__(self):
        for i, e in enumerate(self.events):
            if e.eid != i:
                raise ValueError("event ids must be dense and ordered")

    def by_name(self) -> Mapping[str, EventType]:
        return {e.name: e for e in self.events}

    def to_json(self) -> list:
        return [e.to_json() for e in self.events]

    @staticmethod
    def from_json(items: Iterable[dict]) -> "TraceModel":
        return TraceModel(tuple(EventType.from_json(d) for d in items))


SPAN_EXTRA_FIELDS = (P("ts_begin", "u64"), P("ts_end", "u64"))


def build_trace_model(models: Sequence[APIModel]) -> TraceModel:
    """API models → trace model (Fig 3 middle column).

    Every API yields ``<provider>:<name>_entry`` / ``_exit`` events (or a
    single ``_span`` event for device-span APIs, which carry begin/end device
    timestamps like Level-Zero profiling results read "during wait").
    """
    events = [
        EventType(
            eid=DISCARD_EVENT_ID,
            name=DISCARD_EVENT_NAME,
            provider="ctf",
            api="events_discarded",
            phase="meta",
            fields=(P("count", "u64"),),
        )
    ]
    for model in models:
        for api in model.apis:
            if api.counter:
                events.append(
                    EventType(
                        eid=len(events),
                        name=f"{model.provider}:{api.name}",
                        provider=model.provider,
                        api=api.name,
                        phase="sample",
                        fields=api.entry_fields(),
                        polling=api.is_polling,
                    )
                )
                continue
            if api.span:
                events.append(
                    EventType(
                        eid=len(events),
                        name=f"{model.provider}:{api.name}_span",
                        provider=model.provider,
                        api=api.name,
                        phase="span",
                        fields=SPAN_EXTRA_FIELDS + api.entry_fields() + api.exit_fields(),
                        polling=api.is_polling,
                    )
                )
                continue
            events.append(
                EventType(
                    eid=len(events),
                    name=f"{model.provider}:{api.name}_entry",
                    provider=model.provider,
                    api=api.name,
                    phase="entry",
                    fields=api.entry_fields() + api.dump_fields(),
                    polling=api.is_polling,
                )
            )
            events.append(
                EventType(
                    eid=len(events),
                    name=f"{model.provider}:{api.name}_exit",
                    provider=model.provider,
                    api=api.name,
                    phase="exit",
                    fields=api.exit_fields(),
                    polling=api.is_polling,
                )
            )
    return TraceModel(tuple(events))


# ---------------------------------------------------------------------------
# The built-in API models of this framework's heterogeneous stack.
# Layering (top to bottom), mirroring HIP→Level-Zero in the paper's HIPLZ
# case study (§4.3): ust_repro (framework) → ust_jaxrt (JAX dispatch/memory)
# → ust_kernel / ust_collective (device) → ust_thapi (telemetry daemon).
# ---------------------------------------------------------------------------


def framework_model() -> APIModel:
    """ust_repro — framework-level API (≙ OMPT/Kokkos layer)."""
    return APIModel(
        provider="ust_repro",
        apis=(
            APISpec(
                "train_step",
                params=(P("step", "u64"), P("global_batch", "u32"), P("seq_len", "u32")),
                result=P("status", "u32"),
                meta=(
                    ("OutScalar", P("loss", "f32")),
                    ("OutScalar", P("grad_norm", "f32")),
                    ("Profiled", P("device", "u8")),
                ),
            ),
            APISpec(
                "eval_step",
                params=(P("step", "u64"), P("global_batch", "u32")),
                result=P("status", "u32"),
                meta=(("OutScalar", P("loss", "f32")),),
            ),
            APISpec(
                "data_next",
                params=(P("step", "u64"),),
                result=P("status", "u32"),
                meta=(("OutScalar", P("tokens", "u64")),),
            ),
            APISpec(
                "checkpoint_save",
                params=(P("step", "u64"), P("path", "str"), P("nbytes", "u64")),
                result=P("status", "u32"),
            ),
            APISpec(
                "checkpoint_restore",
                params=(P("path", "str"),),
                result=P("status", "u32"),
                meta=(("OutScalar", P("step", "u64")),),
            ),
            APISpec(
                "optimizer_update",
                params=(P("step", "u64"),),
                result=P("status", "u32"),
                meta=(("OutScalar", P("lr", "f32")),),
            ),
            APISpec(  # serving layer
                "prefill",
                params=(P("request_id", "u64"), P("batch", "u32"), P("seq_len", "u32")),
                result=P("status", "u32"),
                meta=(("Profiled", P("device", "u8")),),
            ),
            APISpec(
                "decode_step",
                params=(P("request_id", "u64"), P("batch", "u32"), P("cache_len", "u32")),
                result=P("status", "u32"),
                meta=(("OutScalar", P("tokens_out", "u32")), ("Profiled", P("device", "u8"))),
            ),
            APISpec(  # spin-lock style completion poll — FULL mode only (§5.2)
                "poll_ready",
                params=(P("handle", "ptr"),),
                result=P("ready", "bool"),
                meta=(("Polling", P("handle", "ptr")),),
            ),
            APISpec(  # §6 adaptive consumer: one advisory per knob change,
                # recorded into the trace so post-mortem analysis sees when
                # and why the session reconfigured itself mid-run
                "advisory",
                params=(P("policy", "str"), P("knob", "str"), P("detail", "str")),
                counter=True,
            ),
        ),
    )


def jaxrt_model() -> APIModel:
    """ust_jaxrt — JAX dispatch + memory layer (≙ lttng_ust_ze / lttng_ust_cuda).

    ``memcpy`` mirrors the paper's zeCommandListAppendMemoryCopy running
    example: src/dst pointers + size let the analysis deduce H2D vs D2H from
    the address classes (§1.1).
    """
    return APIModel(
        provider="ust_jaxrt",
        apis=(
            APISpec(
                "dispatch",
                params=(
                    P("fn", "str"),
                    P("nargs", "u32"),
                    P("arg_bytes", "u64"),
                    P("donated_bytes", "u64"),
                ),
                result=P("status", "u32"),
            ),
            APISpec(
                "compile",
                params=(P("fn", "str"), P("fingerprint", "u64")),
                result=P("status", "u32"),
                meta=(("OutScalar", P("cache_hit", "bool")),),
            ),
            APISpec(
                "memcpy",
                params=(
                    P("src", "ptr"),
                    P("dst", "ptr"),
                    P("nbytes", "u64"),
                    P("kind", "u8"),  # 0 h2d, 1 d2h, 2 d2d
                ),
                result=P("status", "u32"),
                meta=(("ArgDump", P("payload_head", "bytes")),),
            ),
            APISpec(
                "alloc",
                params=(P("nbytes", "u64"), P("device", "u8")),
                result=P("ptr", "ptr"),
            ),
            APISpec("free", params=(P("ptr", "ptr"),), result=P("status", "u32")),
            APISpec(
                "block_until_ready",
                params=(P("handle", "ptr"),),
                result=P("status", "u32"),
                meta=(("Polling", P("handle", "ptr")),),
            ),
        ),
    )


def kernel_model() -> APIModel:
    """ust_kernel — device execution spans (≙ GPU kernel timings, Fig 2
    Scenario 2 'GPU profiling code'). Span events carry device begin/end."""
    return APIModel(
        provider="ust_kernel",
        apis=(
            APISpec(
                "launch",
                params=(
                    P("name", "str"),
                    P("grid_x", "u32"),
                    P("grid_y", "u32"),
                    P("grid_z", "u32"),
                    P("flops", "u64"),
                    P("bytes_accessed", "u64"),
                ),
                span=True,
            ),
            APISpec(
                "transfer",
                params=(P("nbytes", "u64"), P("kind", "u8")),
                span=True,
            ),
        ),
    )


def collective_model() -> APIModel:
    """ust_collective — XLA/communication layer (≙ MPI model in THAPI)."""
    return APIModel(
        provider="ust_collective",
        apis=(
            APISpec(
                "all_reduce",
                params=(P("nbytes", "u64"), P("axis", "str"), P("n_devices", "u32")),
                span=True,
            ),
            APISpec(
                "all_gather",
                params=(P("nbytes", "u64"), P("axis", "str"), P("n_devices", "u32")),
                span=True,
            ),
            APISpec(
                "reduce_scatter",
                params=(P("nbytes", "u64"), P("axis", "str"), P("n_devices", "u32")),
                span=True,
            ),
            APISpec(
                "all_to_all",
                params=(P("nbytes", "u64"), P("axis", "str"), P("n_devices", "u32")),
                span=True,
            ),
            APISpec(
                "broadcast",
                params=(P("nbytes", "u64"), P("root", "u32"), P("n_devices", "u32")),
                span=True,
            ),
            APISpec(
                "barrier",
                params=(P("name", "str"), P("n_devices", "u32")),
                span=True,
            ),
        ),
    )


def telemetry_model() -> APIModel:
    """ust_thapi — device-sampling daemon counters (≙ Sysman telemetry, §3.5).

    PVC power/frequency domains have no CPU analogue; the counter *channel*
    design is identical (daemon, default 50 ms period, streamed to the trace).
    On TPU these bind to libtpu power/HBM counters.
    """
    return APIModel(
        provider="ust_thapi",
        apis=(
            APISpec(
                "sample",
                params=(
                    P("device", "u8"),
                    P("mem_in_use", "u64"),
                    P("mem_peak", "u64"),
                    P("mem_limit", "u64"),
                    P("host_rss", "u64"),
                    P("host_cpu_pct", "f32"),
                    P("step_rate", "f32"),
                ),
                counter=True,
            ),
        ),
    )


def user_model() -> APIModel:
    """ust_user — application-visible user API (≙ Extrae's user events).

    ``annotate`` is a one-shot marker with a JSON-encoded payload;
    ``phase`` is an entry/exit pair bracketing an application phase, so
    user phases tally and fold exactly like traced API calls.  Appended
    *after* the earlier models in :func:`builtin_models` so every
    pre-existing event id is unchanged (trace-format stability across the
    PR sequence); later additions (:func:`remediation_model`) follow the
    same append-only rule.
    """
    return APIModel(
        provider="ust_user",
        apis=(
            APISpec(
                "annotate",
                params=(P("name", "str"), P("payload", "str")),
                counter=True,
            ),
            APISpec(
                "phase",
                params=(P("name", "str"),),
                meta=(("OutScalar", P("name", "str")),),
            ),
        ),
    )


def remediation_model() -> APIModel:
    """ust_repro:remediation — closed-loop control decisions (one event per
    ladder action, ROADMAP "closed-loop remediation").

    A separate trailing :class:`APIModel` (same ``ust_repro`` provider string
    as :func:`framework_model`) rather than a new API inside it: models are
    eid-ordered by position, so appending a model keeps every pre-existing
    event id stable while the event still folds and tallies under the
    ``ust_repro:remediation`` name.
    """
    return APIModel(
        provider="ust_repro",
        apis=(
            APISpec(
                "remediation",
                params=(
                    P("action", "str"),  # escalate_fidelity / checkpoint_drain / evict / ...
                    P("target", "str"),  # rank source id, or "" for run-wide actions
                    P("detail", "str"),  # reason / rung / dry_run marker
                ),
                counter=True,
            ),
        ),
    )


def torchrt_model() -> APIModel:
    """ust_torchrt — PyTorch dispatch + memory layer (≙ lttng_ust_cuda).

    The same API shapes as :func:`jaxrt_model` under the PyTorch runtime's
    provider name: ``dispatch``/``compile`` bracket an eager step, and
    ``block_until_ready`` is the CUDA-event fence.  Appended after
    :func:`remediation_model` so every earlier event id — and with them
    every trace the JAX runtime writes — keeps its meaning.
    """
    jax_apis = jaxrt_model().apis
    return APIModel(provider="ust_torchrt", apis=jax_apis)


def builtin_models() -> Tuple[APIModel, ...]:
    return (
        framework_model(),
        jaxrt_model(),
        kernel_model(),
        collective_model(),
        telemetry_model(),
        user_model(),
        remediation_model(),  # appended models keep earlier eids stable
        torchrt_model(),
    )


def builtin_trace_model() -> TraceModel:
    return build_trace_model(builtin_models())
