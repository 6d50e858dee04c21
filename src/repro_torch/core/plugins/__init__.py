"""Analysis plugins ported so far: the §4.3 tally."""

from . import tally  # noqa: F401
