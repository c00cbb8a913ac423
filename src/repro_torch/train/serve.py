"""Serving steps: batched prefill + greedy decode with decode caches (ring KV
caches for attention, conv and SSD states for Mamba2). An encoder-decoder's
encoder and cross K/V run once per request, before the decode loop."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD


def make_prefill(cfg: ModelConfig):
    def prefill(params, batch, enc_kv=None):
        return MD.prefill(params, cfg, batch, enc_kv=enc_kv)
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode(params, caches, token, pos, enc_kv=None):
        return MD.decode_step(params, cfg, caches, token, pos, enc_kv=enc_kv)
    return decode


@torch.inference_mode()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    n_steps: int, seq_cap: Optional[int] = None,
                    batch_extras: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Prefill-by-decode over ``prompt`` [B,S], then ``n_steps`` greedy tokens
    [B,n_steps], on ``prompt``'s device. Caches are bf16 (Mamba2's SSD state
    fp32), as the reference's. An encoder-decoder takes its ``frames`` in
    ``batch_extras``."""
    B, S = prompt.shape
    cap = seq_cap or (S + n_steps)
    caches = MD.init_decode_caches(cfg, B, cap, device=prompt.device)
    enc_kv = None
    if cfg.is_encoder_decoder:
        enc_kv = MD.encode(params, cfg, batch_extras["frames"].to(prompt.device))
    logits = None
    for pos in range(S):
        logits, caches = MD.decode_step(params, cfg, caches,
                                        prompt[:, pos:pos + 1], pos,
                                        enc_kv=enc_kv)
    out = [torch.argmax(logits, dim=-1)[:, None]]
    for i in range(n_steps - 1):
        logits, caches = MD.decode_step(params, cfg, caches, out[-1], S + i,
                                        enc_kv=enc_kv)
        out.append(torch.argmax(logits, dim=-1)[:, None])
    return torch.cat(out, dim=1)
