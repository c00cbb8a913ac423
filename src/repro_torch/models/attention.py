"""GQA attention with QKV bias, a ring KV cache and cross-attention to given
K/V (``repro.models.attention``, the GQA subset).

``attend`` sends q/k/v to ``kernels.ops.attention``: the CUDA flash kernel on
the card, its plain version on the CPU. The plain version, the reference's
``attend_naive`` with its ``_mask_bias``, is
``kernels.flash_attention.attention_plain`` (and ``mask_bias``), beside the
kernel it stands for.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, dense, init_dense


class AttnSpec(NamedTuple):
    """Resolved per-call attention behaviour."""
    causal: bool = True
    window: int = 0          # 0 -> global
    logit_softcap: float = 0.0
    scale: float = 0.0       # 0 -> 1/sqrt(head_dim)


def attend(q, k, v, q_pos, kv_pos, spec: AttnSpec) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k,v: [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd]."""
    return ops.attention(q, k, v, q_pos, kv_pos, spec)


def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    d, hd = cfg.d_model, cfg.get_head_dim()
    bias = cfg.qkv_bias
    return {
        "wq": init_dense(gen, d, cfg.n_heads * hd, dtype, bias=bias),
        "wk": init_dense(gen, d, cfg.n_kv_heads * hd, dtype, bias=bias),
        "wv": init_dense(gen, d, cfg.n_kv_heads * hd, dtype, bias=bias),
        "wo": init_dense(gen, cfg.n_heads * hd, d, dtype),
    }


def gqa_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                spec: AttnSpec, positions: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, ...]] = None,
                cache_pos: Optional[int] = None,
                kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x: [B,S,D]; positions: int32 [S]. cache: (k, v, pos) with k,v
    [B,cap,Hkv,hd] ring buffers and pos [cap] the absolute position held in
    each slot (PAD_POS when empty).

    * prefill: cache is None -> attend within x, return (y, (k, v, positions)).
    * decode: the new k/v/positions are written in place at slot
      ``cache_pos % cap`` and the updated cache tensors are returned.
    * cross-attention: ``kv_override`` gives precomputed (k, v)
      [B,T,Hkv,hd] at positions ``arange(T)``; neither q nor k is rotated
      and no cache is written.
    """
    B, S, _ = x.shape
    hd = cfg.get_head_dim()
    q = dense(params["wq"], x).view(B, S, cfg.n_heads, hd)
    if kv_override is not None:
        k, v = kv_override
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
        o = attend(q, k, v, positions, kv_pos, spec)
        return dense(params["wo"], o.reshape(B, S, cfg.n_heads * hd)), (k, v, positions)
    k = dense(params["wk"], x).view(B, S, cfg.n_kv_heads, hd)
    v = dense(params["wv"], x).view(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv, cpos = cache
        cap = ck.shape[1]
        # Index assignment in place replaces JAX's functional
        # dynamic_update_slice; like it, a start that would run past the end
        # is clamped so the S new rows fit.
        slot = min(int(cache_pos) % cap, cap - S)
        ck[:, slot:slot + S] = k.to(ck.dtype)
        cv[:, slot:slot + S] = v.to(cv.dtype)
        cpos[slot:slot + S] = positions.to(cpos.dtype)
        o = attend(q, ck, cv, positions, cpos, spec)
        new_cache = (ck, cv, cpos)
    else:
        o = attend(q, k, v, positions, positions, spec)
        new_cache = (k, v, positions)
    y = dense(params["wo"], o.reshape(B, S, cfg.n_heads * hd))
    return y, new_cache
