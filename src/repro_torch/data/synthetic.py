"""Synthetic data (deterministic, step-indexed), as torch tensors: LM
tokens, the vision stub's patch embeddings, whisper's stub frames and LeNet
image batches.

The draws are the reference's numpy draws (``SeedSequence([seed, step])``),
so a batch is bit-equal to ``repro.data``'s for the same arguments.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.lenet5 import DATASET_SHAPES, LeNet5Config, N_CLASSES


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
    """The batch of ``repro.data.make_batch_for``, on the CPU: tokens; for
    the vision stub the patch embeddings ``patches`` [batch,
    n_frontend_tokens, d_model] fp32, with the tokens cut to ``max(seq - n,
    1)``; for an encoder-decoder the stub frame embeddings ``frames``
    [batch, encoder_seq_len, d_model] fp32. Patches, then frames, are drawn
    from one ``SeedSequence([seed, step, 7])`` generator (normal × 0.02)."""
    out = {"tokens": TokenStream(cfg.vocab_size, batch, seq, seed).batch(step)}
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    if cfg.frontend == "vision_patch_stub":
        n = cfg.n_frontend_tokens
        out["tokens"] = out["tokens"][:, :max(seq - n, 1)]
        out["patches"] = torch.from_numpy(rng.normal(
            size=(batch, n, cfg.d_model)).astype(np.float32) * 0.02)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32) * 0.02)
    return out


def image_batch(shape, batch: int, step: int, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``repro.data.synthetic.image_batch``'s draws as numpy: images
    ``[batch, *shape]`` fp32 N(0, 1) and int32 labels in [0, 10)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    images = rng.normal(size=(batch,) + tuple(shape)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, size=(batch,)).astype(np.int32)
    return images, labels


def lenet_batch(cfg: LeNet5Config, step: int = 0, seed: int = 0,
                batch: Optional[int] = None, device="cpu"
                ) -> Dict[str, torch.Tensor]:
    """The reference's LeNet batch in the port's layout: images NCHW (the
    reference's NHWC draws, transposed on the host), labels int64 (torch's
    index type), both on ``device``."""
    images, labels = image_batch(DATASET_SHAPES[cfg.dataset],
                                 batch or cfg.batch_size, step, seed)
    nchw = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
    return {"images": torch.from_numpy(nchw).to(device),
            "labels": torch.from_numpy(labels.astype(np.int64)).to(device)}
