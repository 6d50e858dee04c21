"""Partitioning and collectives over a mesh of ``torch.distributed`` ranks:
the JAX package's ``sharding`` with the ``shard_map`` collectives the port
runs itself."""

from .partition import (  # noqa: F401
    FSDP_OVERRIDES,
    LOGICAL_RULES,
    SERVE2D_OVERRIDES,
    PartitionSpec,
    Partitioner,
    logical_to_pspec,
    spec_items,
)
from .placement import Placed, at_use, gather_to_host, gather_whole, local_block, place, reshard, take  # noqa: F401
