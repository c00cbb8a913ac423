"""Deterministic synthetic data (no downloads)."""
from repro_torch.data.synthetic import TokenStream, make_batch_for

__all__ = ["TokenStream", "make_batch_for"]
