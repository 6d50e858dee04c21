"""On-node processing & multi-rank aggregation (THAPI §3.7).

For large-scale runs THAPI saves only the *aggregate* of each rank's trace
(kilobytes), then "each local master sends its aggregate to the global
master, where the summaries are combined into a composite profile" — the
paper validated this to 512 nodes.

Tallies are mergeable monoids (plugins/tally.py), so the composite profile is
a tree reduction:

    rank tallies ──▶ local master (per node) ──▶ global master

``aggregate_tree`` implements the reduction generically (configurable fanout)
and reports tree statistics; ``combine_trace_dirs`` / ``combine_aggregates``
are the file-based transports used between processes (each rank writes
``aggregate_rank<k>.tally``; masters read + merge).  Serialization is msgpack
— compact, schema-free, fast.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, List, Sequence, TypeVar

import msgpack

from .plugins.tally import Tally, tally_trace

T = TypeVar("T")


# ---------------------------------------------------------------------------
# Tally (de)serialization
# ---------------------------------------------------------------------------


def save_tally(t: Tally, path: str) -> int:
    blob = msgpack.packb(t.to_obj(), use_bin_type=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return len(blob)


def load_tally(path: str) -> Tally:
    with open(path, "rb") as f:
        return Tally.from_obj(msgpack.unpackb(f.read(), raw=False))


# ---------------------------------------------------------------------------
# Tree reduction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeStats:
    leaves: int
    fanout: int
    depth: int
    messages: int


def aggregate_tree(
    items: Sequence[T],
    reducer: Callable[[T, T], T],
    fanout: int = 32,
) -> tuple:
    """Reduce ``items`` through a fanout-ary master tree.

    Level 0 = ranks; each group of ``fanout`` merges into its local master;
    repeat until one composite remains (the global master's profile).
    Returns (composite, TreeStats).
    """
    if not items:
        raise ValueError("nothing to aggregate")
    level: List[T] = list(items)
    depth = 0
    messages = 0
    while len(level) > 1:
        nxt: List[T] = []
        for i in range(0, len(level), fanout):
            group = level[i : i + fanout]
            acc = group[0]
            for other in group[1:]:
                acc = reducer(acc, other)
                messages += 1
            nxt.append(acc)
        level = nxt
        depth += 1
    return level[0], TreeStats(leaves=len(items), fanout=fanout, depth=depth, messages=messages)


def merge_tallies(tallies: Sequence[Tally], fanout: int = 32) -> tuple:
    return aggregate_tree(list(tallies), lambda a, b: a.merge(b), fanout)


# ---------------------------------------------------------------------------
# File transports
# ---------------------------------------------------------------------------


def combine_aggregates(paths: Iterable[str], fanout: int = 32) -> Tally:
    """Global master: merge per-rank ``.tally`` files into a composite."""
    tallies = [load_tally(p) for p in paths]
    composite, _ = merge_tallies(tallies, fanout)
    return composite


def combine_trace_dirs(
    trace_dirs: Iterable[str], fanout: int = 32, legacy_graph: bool = False
) -> Tally:
    """Merge full trace directories (re-tallying each) into a composite.

    Each directory is tallied through the single-pass fold engine by
    default; ``legacy_graph=True`` routes through the Babeltrace-style
    graph (identical result, for cross-checking)."""
    tallies = [tally_trace(d, legacy_graph=legacy_graph) for d in trace_dirs]
    composite, _ = merge_tallies(tallies, fanout)
    return composite


def find_aggregates(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".tally"):
                out.append(os.path.join(dirpath, name))
    return sorted(out)
