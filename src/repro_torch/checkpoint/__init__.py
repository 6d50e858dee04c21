"""Atomic, async, integrity-checked checkpoints in the JAX package's format."""

from .checkpointer import Checkpointer, CheckpointManifest, latest_checkpoint, list_checkpoints  # noqa: F401
