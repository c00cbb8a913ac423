"""Deterministic synthetic data (no downloads)."""
from repro_torch.data.synthetic import (TokenStream, image_batch, lenet_batch,
                                        make_batch_for)

__all__ = ["TokenStream", "image_batch", "lenet_batch", "make_batch_for"]
