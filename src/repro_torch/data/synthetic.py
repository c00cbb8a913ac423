"""Synthetic LM tokens (deterministic, step-indexed), as torch tensors.

The draws are the reference's numpy draws (``SeedSequence([seed, step])``),
so a batch is bit-equal to ``repro.data.TokenStream``'s for the same
arguments.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class TokenStream:
    """Zipf-like token batches; ``batch(step)`` depends on ``step`` only."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch_size, self.seq, self.seed = vocab, batch, seq, seed
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = (p / p.sum()).astype(np.float64)

    def batch_np(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        return rng.choice(self.vocab, size=(self.batch_size, self.seq),
                          p=self._p).astype(np.int32)

    def batch(self, step: int) -> torch.Tensor:
        """[batch, seq] int32 tokens on the CPU."""
        return torch.from_numpy(self.batch_np(step))


def make_batch_for(cfg: ModelConfig, batch: int, seq: int, step: int = 0,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """The token batch of ``repro.data.make_batch_for`` (text models only)."""
    if cfg.frontend != "none" or cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: frontend inputs not ported yet")
    return {"tokens": TokenStream(cfg.vocab_size, batch, seq, seed).batch(step)}
