"""Observability (``repro.obs``): the span recorder the sweeps use."""
