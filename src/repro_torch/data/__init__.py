"""Deterministic, resumable data pipeline."""

from repro_torch.data.pipeline import TokenStream

__all__ = ["TokenStream"]
