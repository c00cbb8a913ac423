"""GQA attention with QKV bias, a ring KV cache and cross-attention to given
K/V, and DeepSeek's multi-head latent attention (``repro.models.attention``).

``attend`` sends q/k/v to ``kernels.ops.attention``: the CUDA flash kernel on
the card, its plain version on the CPU. The plain version, the reference's
``attend_naive`` with its ``_mask_bias``, is
``kernels.flash_attention.attention_plain`` (and ``mask_bias``), beside the
kernel it stands for. MLA's training and prefill path expands K/V out of
the latent and attends through the same ``attend`` (the flash kernel at qk
dim 192, v zero-padded to it); its decode over the latent cache is the
absorbed form in fp32 products, with no kernel, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import mask_bias
from repro_torch.dist.sharding import axis_group
from repro_torch.models.layers import (Params, apply_rope, dense, init_dense,
                                       local_dim, marks, tp_f, tp_probe)


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
                axes=None) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x: [B,S,D]; positions: int32 [S]. cache: (k, v, pos) with k,v
    [B,cap,Hkv,hd] ring buffers and pos [cap] the absolute position held in
    each slot (PAD_POS when empty).

    * prefill: cache is None -> attend within x, return (y, (k, v, positions)).
    * decode: the new k/v/positions are written in place at slot
      ``cache_pos % cap`` and the updated cache tensors are returned.
    * cross-attention: ``kv_override`` gives precomputed (k, v)
      [B,T,Hkv,hd] at positions ``arange(T)``; neither q nor k is rotated
      and no cache is written.

    Local heads (the overlap train step): a ``LocalDim`` on wq's and wk's
    output dims means this rank holds 1/m of the q and kv heads; the input
    enters through ``tp_f`` and wo's row split is closed by ``dense``.
    """
    B, S, _ = x.shape
    hd = cfg.get_head_dim()
    nH, nKV = cfg.n_heads, cfg.n_kv_heads
    colq = local_dim(marks(axes, "wq", "weight", 0))
    colk = local_dim(marks(axes, "wk", "weight", 0))
    if colq is not None:
        x = tp_f(axis_group(colq.axis), x)
        nH //= colq.size
    if colk is not None:
        nKV //= colk.size
    wo = marks(axes, "wo")
    q = tp_probe("attn_q", dense(params["wq"], x).view(B, S, nH, hd))
    if kv_override is not None:
        k, v = kv_override
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
        o = attend(q, k, v, positions, kv_pos, spec)
        return dense(params["wo"], o.reshape(B, S, nH * hd), wo), (k, v, positions)
    k = dense(params["wk"], x).view(B, S, nKV, hd)
    v = dense(params["wv"], x).view(B, S, nKV, hd)
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
    y = dense(params["wo"], o.reshape(B, S, nH * hd), wo)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """Down-projections of q (``wq_a``) and of the kv latent plus the shared
    rope key (``wkv_a``), up-projections out of them, and ``wo``."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": init_dense(gen, d, m.q_lora_rank, dtype),
        "wq_b": init_dense(gen, m.q_lora_rank, H * qk, dtype),
        "wkv_a": init_dense(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        "wk_b": init_dense(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, dtype),
        "wv_b": init_dense(gen, m.kv_lora_rank, H * m.v_head_dim, dtype),
        "wo": init_dense(gen, H * m.v_head_dim, d, dtype),
    }


def mla_local_heads(cfg: ModelConfig, axes=None) -> int:
    """Heads on this rank: n_heads / m when wq_b's output dim is local."""
    col = local_dim(marks(axes, "wq_b", "weight", 0))
    return cfg.n_heads // col.size if col is not None else cfg.n_heads


def mla_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, axes=None):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope] rotated, latent [B,S,rank],
    k_rope [B,S,rope] rotated). Head-parallel (a ``LocalDim`` on wq_b's
    output dim): ``tp_f`` sits after the replicated down-projections, so
    their grads and the cotangent upstream are completed by its psum."""
    m = cfg.mla
    B, S, _ = x.shape
    lat_q = dense(params["wq_a"], x)
    kv = dense(params["wkv_a"], x)
    col = local_dim(marks(axes, "wq_b", "weight", 0))
    if col is not None:
        group = axis_group(col.axis)
        lat_q, kv = tp_f(group, lat_q), tp_f(group, kv)
    q = dense(params["wq_b"], lat_q)
    q = tp_probe("attn_q", q.view(B, S, mla_local_heads(cfg, axes),
                                  m.qk_nope_head_dim + m.qk_rope_head_dim))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    latent = kv[..., :m.kv_lora_rank]
    k_rope = apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, latent, k_rope


def mla_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                spec: AttnSpec, positions: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, ...]] = None,
                cache_pos: Optional[int] = None, axes=None):
    """MLA attention. cache = (latent [B,cap,rank], k_rope [B,cap,rope],
    pos [cap]) ring buffers.

    * train/prefill (no cache): K/V expanded out of the latent, attended
      with Hkv = H at qk dim nope + rope, v zero-padded to that dim and
      sliced after; returns (y, (latent, k_rope, positions)).
    * decode: the new latent, rope key and positions are written in place
      at slot ``cache_pos % cap``; scores and values live in latent space
      (W_uk absorbed into q, W_uv applied after), fp32 products.
    ``axes`` may keep the heads local (``mla_qkv``), wo's row split closed
    by ``dense``; the latent and rope caches stay whole."""
    m = cfg.mla
    B, S, _ = x.shape
    H = mla_local_heads(cfg, axes)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope, latent, k_rope = mla_qkv(params, x, cfg, positions, axes)

    if cache is None:
        k_nope = dense(params["wk_b"], latent).view(B, S, H, m.qk_nope_head_dim)
        v = dense(params["wv_b"], latent).view(B, S, H, m.v_head_dim)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, m.qk_rope_head_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        v_pad = F.pad(v, (0, q_full.shape[-1] - m.v_head_dim))
        o = attend(q_full, k_full, v_pad, positions, positions,
                   spec._replace(scale=scale))[..., :m.v_head_dim]
        y = dense(params["wo"], o.reshape(B, S, H * m.v_head_dim), marks(axes, "wo"))
        return y, (latent, k_rope, positions)

    c_lat, c_rope, cpos = cache
    cap = c_lat.shape[1]
    slot = min(int(cache_pos) % cap, cap - S)
    c_lat[:, slot:slot + S] = latent.to(c_lat.dtype)
    c_rope[:, slot:slot + S] = k_rope.to(c_rope.dtype)
    cpos[slot:slot + S] = positions.to(cpos.dtype)
    wk_b = params["wk_b"]["weight"].view(H, m.qk_nope_head_dim, m.kv_lora_rank)
    q_lat = torch.einsum("bshn,hnr->bshr", q_nope.float(), wk_b.float())
    lat = c_lat.float()
    s = (torch.einsum("bshr,btr->bhst", q_lat, lat)
         + torch.einsum("bshn,btn->bhst", q_rope.float(), c_rope.float())) * scale
    s = s + mask_bias(positions, cpos, spec)[None, None]
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", p, lat)
    wv_b = params["wv_b"]["weight"].view(H, m.v_head_dim, m.kv_lora_rank)
    o = torch.einsum("bshr,hvr->bshv", o_lat, wv_b.float())
    y = dense(params["wo"], o.reshape(B, S, H * m.v_head_dim).to(x.dtype),
              marks(axes, "wo"))
    return y, (c_lat, c_rope, cpos)
