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
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.interception import TracedStep, decode_step_span, prefill_span
from repro_torch.models import Model, ShapeSpec
from repro_torch.models.param import zeros as spec_zeros

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


class ServeEngine:
    def __init__(self, model: Model, params: dict, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["tok"].device
        self._rid = itertools.count()
        B = cfg.batch_slots
        shape = ShapeSpec("serve", "decode", cfg.cache_len, B)
        self.cache = spec_zeros(model.cache_specs(shape), model.cfg.dtype, self.device)
        #: the step callable of ``decode_artifacts``: a DecodeGraph on the card
        self.decode_fn = decode_artifacts(model, self.device)
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
            batch = {"tokens": torch.as_tensor(r.prompt[None, :], device=self.device)}
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
        self._splice_tree(self.cache, row, slot)

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
