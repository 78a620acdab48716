"""Deterministic token pipeline (the port's copy of ``repro.data``)."""

from .pipeline import DataConfig, TokenPipeline, synthetic_corpus

__all__ = ["DataConfig", "TokenPipeline", "synthetic_corpus"]
