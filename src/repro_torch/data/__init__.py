"""Deterministic synthetic data for the trainer."""

from .pipeline import DataConfig, SyntheticPipeline, make_eval_batch  # noqa: F401
