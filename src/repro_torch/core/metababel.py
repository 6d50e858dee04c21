"""Metababel: callback-dispatch generation over the trace model (THAPI §3.4).

THAPI's Metababel "attaches user-defined callbacks to trace events (generated
automatically from the LTTng trace model)", abstracting Babeltrace2's CTF
reading, field unpacking and message plumbing so plugins are just *collections
of callbacks*.

We generate, per trace model, a ``process(events)`` dispatch loop whose body
is specialized source code (one flat list indexed by event id — no dict
lookups or string compares on the hot path), exactly the role Metababel's
generated C plays.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from .api_model import TraceModel
from .babeltrace import Event

_DISPATCH_SRC = """
def process(events, _cbs=_cbs, _default=_default):
    n = 0
    for ev in events:
        cb = _cbs[ev.etype.eid]
        if cb is not None:
            cb(ev)
        elif _default is not None:
            _default(ev)
        n += 1
    return n
"""


class Dispatcher:
    """Plugin base: register callbacks by event name, run over a stream.

    >>> d = Dispatcher(model)
    >>> d.on("ust_torchrt:memcpy_entry", lambda ev: ...)
    >>> d.run(CTFSource(trace_dir))
    """

    def __init__(self, model: TraceModel, default: Optional[Callable[[Event], None]] = None):
        self.model = model
        self._cbs: List[Optional[Callable[[Event], None]]] = [None] * len(model.events)
        self._default = default
        self._process = None  # generated lazily after registration settles

    def on(self, event_name: str, cb: Callable[[Event], None]) -> "Dispatcher":
        ev = self.model.by_name()[event_name]
        self._cbs[ev.eid] = cb
        self._process = None
        return self

    def on_provider(self, provider: str, cb: Callable[[Event], None]) -> "Dispatcher":
        for ev in self.model.events:
            if ev.provider == provider:
                self._cbs[ev.eid] = cb
        self._process = None
        return self

    def _gen(self):
        ns = {"_cbs": self._cbs, "_default": self._default}
        exec(compile(_DISPATCH_SRC, "<metababel dispatch>", "exec"), ns)
        return ns["process"]

    def run(self, events: Iterable[Event]) -> int:
        if self._process is None:
            self._process = self._gen()
        return self._process(events)
