"""Deterministic, restart-safe synthetic data pipeline."""

from .pipeline import DataConfig, data_iterator, lm_tokens, synthetic_batch

__all__ = ["DataConfig", "data_iterator", "lm_tokens", "synthetic_batch"]
