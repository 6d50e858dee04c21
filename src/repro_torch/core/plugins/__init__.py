"""Babeltrace2-style analysis plugins generated over the trace model
(THAPI §3.4): Pretty Print, Tally, Timeline, and the post-mortem validation
plugin of §4.2."""

from . import pretty, tally, timeline, validate  # noqa: F401
