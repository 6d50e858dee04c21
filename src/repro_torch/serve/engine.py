"""Batched serving engine: prefill + continuous decode over slot batches.

The engine owns a fixed slot batch.  Requests queue; a slot is (re)filled by
running prefill for the incoming prompt and splicing its cache row into the
live batch cache; every ``step()`` decodes one token for all slots.  Both
phases run through THAPI ``prefill``/``decode_step`` spans and
:class:`TracedStep` launches — the serving tally of §4.3.

The engine runs on the device its parameters live on.  It owns its cache:
the splice writes a prefill row into it in place, and the decode step,
whose cache argument is donated as in the JAX engine, writes the new rows
and states into it and returns it.  On the card the decode step is a CUDA
graph (``artifacts.decode_artifacts``), captured at the first step and
replayed at every later one over the same parameters, cache leaves and
token buffer, so the engine never rebinds them.  Token tensors are int32,
as the JAX engine's are.

Adaptive policies (``adaptive=``, ``cluster_adaptive=``) tick between the
decode step and the token readback, as in the JAX engine: on the card after
the replay is enqueued and before the host waits for its tokens.  A tick
reads the live tally, never a tensor, and no knob it turns (tracing mode,
fidelity, cadence, ``cfg.max_new_tokens``) touches the captured graph, so an
engine captures its decode step once.  ``live_tally`` / ``live_profile``
report the surrounding session's live composite mid-run.

With a ``partitioner`` (as the JAX engine takes one) every rank of its
mesh runs the same schedule: each rank holds its block of the parameters
(``artifacts.place_params``) and of every cache leaf (``artifacts.
cache_specs``: its slots over the data axes, its KV heads over "model"),
runs every prompt's prefill on its heads, splices the prompt's row into
its blocks only where it holds that slot, decodes its slots and ends each
step with every slot's token (the step's logits gathered whole).  Over
``gloo`` the decode step runs eagerly, and the engine says so in
``decode_note`` and one printed line (``artifacts.eager_reason``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.interception import TracedStep, decode_step_span, prefill_span
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.param import DTYPES
from repro_torch.models.param import zeros as spec_zeros
from repro_torch.sharding.placement import Placed, block_shape, local_block

from . import artifacts
from .artifacts import decode_artifacts


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 4
    cache_len: int = 128
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: length-only stopping (synthetic serving)
    greedy: bool = True  # the JAX config's field; decoding is greedy either way


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def prompt_batch(model: Model, tokens: torch.Tensor) -> dict:
    """A prefill's batch: the tokens ``[B, S]`` and, for the audio family,
    the stub frontend's frames, zeros ``[B, enc_positions, d_model]`` in the
    model dtype on the tokens' device, as the JAX engine feeds them."""
    batch = {"tokens": tokens}
    mc = model.cfg
    if mc.family == "audio":
        batch["frames"] = torch.zeros(
            (tokens.shape[0], mc.encdec.enc_positions, mc.d_model), dtype=DTYPES[mc.dtype], device=tokens.device
        )
    return batch


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params: dict,
        cfg: ServeConfig,
        partitioner=None,
        adaptive=None,
        cluster_adaptive=None,
        cluster_credentials: Optional[dict] = None,
    ):
        if model.cfg.vision_tokens:
            raise NotImplementedError(
                f"{model.cfg.name}: the engine feeds no patch_embeds, as the JAX engine feeds "
                "none; drive a VLM through Model.prefill / decode_step"
            )
        self.partitioner = partitioner
        if partitioner is not None:
            model = model.on_mesh(partitioner.mesh)
            params = artifacts.place_params(model, params, partitioner)
        self.model = model
        self.cfg = cfg
        self.params = params
        # §6 adaptive consumer: a list of AdaptivePolicy (or a ready
        # AdaptiveController) ticked between decode steps with ctx.engine
        # bound, so policies can reach serving knobs (cfg.max_new_tokens,
        # queue depth) next to the tracing ones.  The controller attaches
        # itself to the active session on its first tick, so the Tracer may
        # start before or after the engine is built.  cluster_adaptive:
        # ClusterPolicy list (or ready controller) ticked the same way; it
        # reads the per-rank map of the session's in-process master
        # (TraceConfig.serve_port), or the master that cluster_credentials
        # ({"addr": ..., "token": ..., "tls_ca": ...}) name.
        from repro_torch.core.adaptive import build_cluster_controller, build_controller

        self.adaptive = build_controller(adaptive)
        self.cluster_adaptive = build_cluster_controller(
            cluster_adaptive, **(cluster_credentials or {})
        )
        tok = params["embed"]["tok"]
        self.device = (tok.local if isinstance(tok, Placed) else tok).device
        self._rid = itertools.count()
        B = cfg.batch_slots
        shape = ShapeSpec("serve", "decode", cfg.cache_len, B)
        #: the decode step's reason to run eagerly on the card, or None
        self.decode_note = None
        if partitioner is None:
            self.cache = spec_zeros(model.cache_specs(shape), model.cfg.dtype, self.device)
            #: the step callable of ``decode_artifacts``: a DecodeGraph on the card
            self.decode_fn = decode_artifacts(model, self.device)
        else:
            self._cache_specs = artifacts.cache_specs(model, partitioner, shape)
            self.cache = self._block_zeros(model.cache_specs(shape), self._cache_specs)
            held = local_block(torch.arange(B), artifacts.batch_specs(model, partitioner, shape)["token"],
                               partitioner.mesh)
            #: (the first slot this rank's cache blocks hold, how many)
            self._slots = (int(held[0]), held.numel())
            self.decode_fn = decode_artifacts(model, self.device, partitioner)
            if self.device.type == "cuda":
                self.decode_note = artifacts.eager_reason(partitioner)
            if self.decode_note:
                print(f"[engine] {model.cfg.name}: {self.decode_note}", flush=True)
        self._decode = TracedStep(
            self.decode_fn,
            name=f"decode_step[{model.cfg.name}]",
            device=self.device,
            flops=2 * model.cfg.active_params() * B,
            donate_argnums=(1,),
        )
        self.slots: List[Optional[Request]] = [None] * B
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        #: the decode step's token input, written in place (the graph reads it)
        self._tok = torch.zeros(B, dtype=torch.int32, device=self.device)
        self._prefill_steps: Dict[int, TracedStep] = {}

    # -- request intake -----------------------------------------------------------
    def submit(self, prompt: np.ndarray) -> Request:
        r = Request(rid=next(self._rid), prompt=np.asarray(prompt, np.int32))
        self.queue.append(r)
        return r

    def _fill_slots(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            r = self.queue.pop(0)
            self._prefill_into(i, r)
            self.slots[i] = r

    def _prefill_into(self, slot: int, r: Request) -> None:
        """Prefill a single prompt, splice its cache row into the live batch."""
        S = int(r.prompt.shape[0])
        with prefill_span(r.rid, 1, S):
            batch = prompt_batch(self.model, torch.as_tensor(r.prompt[None, :], device=self.device))
            if S not in self._prefill_steps:  # one first-call record per prompt length
                # the step captures the model, not the engine that holds the
                # step, so no reference cycle keeps the engine alive
                model, cache_len = self.model, self.cfg.cache_len
                self._prefill_steps[S] = TracedStep(
                    lambda p, b: model.prefill(p, b, cache_len),
                    name=f"prefill[{self.model.cfg.name}/S{S}]",
                    device=self.device,
                )
            logits, row = self._prefill_steps[S](self.params, batch)
        first = int(torch.argmax(logits[0, 0, : self.model.cfg.vocab_size]))
        r.out_tokens.append(first)
        self._tok[slot] = first
        if self.partitioner is None:
            self._splice_tree(self.cache, row, slot)
        elif self._slots[0] <= slot < self._slots[0] + self._slots[1]:
            self._splice_tree(self.cache, row, slot - self._slots[0])

    def cache_dtype(self) -> torch.dtype:
        return DTYPES[self.model.cfg.dtype]

    def _block_zeros(self, spec_tree, pspecs):
        """Zeros of this rank's block of every cache leaf."""
        whole = spec_zeros(spec_tree, self.model.cfg.dtype, "meta")

        def walk(t, s):
            if isinstance(t, dict):
                return {k: walk(t[k], s[k]) for k in t}
            if isinstance(t, list):
                return [walk(v, x) for v, x in zip(t, s)]
            return torch.zeros(block_shape(t.shape, s, self.partitioner.mesh), dtype=t.dtype, device=self.device)

        return walk(whole, pspecs)

    @classmethod
    def _splice_tree(cls, cache, row, slot: int) -> None:
        """Splice every leaf of a prefill row's cache tree (nested dicts and
        lists, as the model's ``cache_specs`` declares them) into the live cache."""
        if isinstance(cache, torch.Tensor):
            cls._splice(cache, row, slot)
        elif isinstance(cache, dict):
            for k, leaf in cache.items():
                cls._splice_tree(leaf, row[k], slot)
        else:
            for leaf, r in zip(cache, row, strict=True):
                cls._splice_tree(leaf, r, slot)

    @staticmethod
    def _splice(cache_leaf: torch.Tensor, row_leaf: torch.Tensor, slot: int) -> None:
        """Write the size-1-batch prefill row into ``cache_leaf`` at ``slot``,
        cast to the leaf's current dtype.  The batch axis is the one where the
        shapes differ (layers lead; batch follows); with one slot the row is
        the whole leaf."""
        if row_leaf.shape == cache_leaf.shape:
            cache_leaf.copy_(row_leaf)
            return
        for ax in range(cache_leaf.ndim):
            if row_leaf.shape[ax] == 1 and cache_leaf.shape[ax] != 1:
                cache_leaf.narrow(ax, slot, 1).copy_(row_leaf)
                return
        raise ValueError(
            f"cannot splice a {tuple(row_leaf.shape)} row into a "
            f"{tuple(cache_leaf.shape)} cache leaf"
        )

    # -- decode loop -----------------------------------------------------------------
    def step(self) -> int:
        """One batched decode step; returns #active slots."""
        self._fill_slots()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        rid = self.slots[active[0]].rid
        with decode_step_span(rid, len(active), self.cfg.cache_len) as sp:
            logits, _ = self._decode(self.params, self.cache, {"token": self._tok})  # writes self.cache
            # read before the next step: a replay writes the same logits
            nxt = torch.argmax(logits[:, 0, : self.model.cfg.vocab_size], dim=-1)
            sp.outs["tokens_out"] = len(active)
        self._tok.copy_(nxt)
        # the ticks read the live tally, not tensors: their host time overlaps
        # the step's device time, before the token readback waits for it
        if self.adaptive is not None:
            self.adaptive.tick(engine=self)
        if self.cluster_adaptive is not None:
            self.cluster_adaptive.tick()
        host = nxt.cpu().numpy()
        for i in active:
            r = self.slots[i]
            r.out_tokens.append(int(host[i]))
            if len(r.out_tokens) >= self.cfg.max_new_tokens or int(host[i]) == self.cfg.eos_id:
                r.done = True
                self.completed.append(r)
                self.slots[i] = None
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.completed

    # -- live profile (§3.7+§6 streaming service) ------------------------------
    def live_tally(self):
        """Live tally of the surrounding tracing session, or None.

        Requires the engine to run under ``Tracer(TraceConfig(online=True))``
        (or any streaming knob, which implies it).  With ``serve_port`` set
        the session runs an in-process master, so this is the *global*
        composite — the prefill/decode spans of this server merged with
        every rank streaming into it.
        """
        from repro_torch.core.stream import live_snapshot

        return live_snapshot()

    def live_profile(self, top: Optional[int] = None) -> Optional[str]:
        """Rendered live tally (the §4.3 table) for /profile-style endpoints."""
        from repro_torch.core.plugins.tally import render

        t = self.live_tally()
        return None if t is None else render(t, top=top)
