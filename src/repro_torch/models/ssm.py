"""Mamba2 block (SSD — state-space duality): chunked scan and recurrent
decode (``repro.models.ssm``).

Heads H = expand·d_model / head_dim P, state size N, B/C shared across
``n_groups`` G. Training and prefill run the chunked scan through
``kernels.ops.ssd_chunked``: the CUDA kernel on the card, its plain version
on the CPU. That plain version, the reference's ``ssd_reference``, lives
beside the kernel as ``kernels.ssd_scan.ssd_plain`` and is exported here
under the reference's name. Decode is the O(1)-per-token recurrence on the
carried state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import segsum, ssd_plain as ssd_reference
from repro_torch.models.layers import Params, dense, init_dense, normal_param

__all__ = ["segsum", "ssd_reference", "ssd_decode_step", "init_mamba2",
           "causal_conv", "mamba2_forward"]


def ssd_decode_step(state, x, dt, A, B, C, D):
    """Single-token recurrence. state [b,h,p,n]; x [b,h,p]; dt [b,h];
    B, C [b,g,n]. Returns (y [b,h,p] in x's dtype, new_state)."""
    b, h, p = x.shape
    g = B.shape[1]
    Bh = B.repeat_interleave(h // g, dim=1)                 # [b,h,n]
    Ch = C.repeat_interleave(h // g, dim=1)
    decay = torch.exp(dt * A[None, :])[..., None, None]     # [b,h,1,1]
    upd = (dt[..., None] * x)[..., None] * Bh[:, :, None, :]
    new_state = state * decay + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) + x * D[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype) -> Dict[str, object]:
    """The reference's scales: fan-in normal projections, ``conv_w`` at
    1/d_conv, zero ``conv_b``, ``A_log = log(linspace(1, 16))``,
    ``dt_bias = log(expm1(linspace(dt_min, dt_max)))``, ones for ``D`` and
    ``norm_scale`` (those four fp32)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    dev, f32 = gen.device, torch.float32
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh     # [z, x, B, C, dt]
    return {
        "in_proj": init_dense(gen, cfg.d_model, proj_out, dtype),
        "conv_w": normal_param(gen, (s.d_conv, conv_dim), dtype, 1.0 / s.d_conv),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev)),
        "D": torch.ones(nh, dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.linspace(
            s.dt_min, s.dt_max, nh, dtype=f32, device=dev))),
        "out_proj": init_dense(gen, d_in, cfg.d_model, dtype),
        "norm_scale": torch.ones(d_in, dtype=f32, device=dev),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_in, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, zxbcdt.shape[-1] - 2 * d_in - 2 * gn],
                       dim=-1)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba2's RMSNorm(y * silu(z)) gate."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x [B,L,C]; w [K,C]; state [B,K-1,C] the
    inputs before x (zeros when None). Returns (silu(conv + b), the trailing
    K-1 inputs: the next decode state)."""
    K, L = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return F.silu(y + b[None, None, :]), new_state


def mamba2_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Mamba2 block. x [B,L,D]; cache = (conv_state [B,K-1,conv_dim],
    ssd_state [B,H,P,N]) for decode (L = 1), None for training and prefill.
    Returns (y, new_cache): with a cache, the new states (the caller writes
    them back); without, (conv tail, final SSD state in x's dtype)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    B_, L, _ = x.shape
    gn = s.n_groups * s.d_state
    zxbcdt = dense(params["in_proj"], x)
    z, _, _, _, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    conv_in = zxbcdt[..., d_in:d_in + conv_dim]         # [x, B, C], no copy

    if cache is None:
        conv_out, conv_tail = causal_conv(conv_in, params["conv_w"],
                                          params["conv_b"])
        xh = conv_out[..., :d_in].reshape(B_, L, nh, s.head_dim)
        Bh = conv_out[..., d_in:d_in + gn].reshape(B_, L, s.n_groups, s.d_state)
        Ch = conv_out[..., d_in + gn:].reshape(B_, L, s.n_groups, s.d_state)
        pad = (-L) % s.chunk_size
        if pad:             # dt = x = B = C = 0 leave the state as it is
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
            Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
        y, final_state = ops.ssd_chunked(xh, dt, A, Bh, Ch, params["D"],
                                         chunk=s.chunk_size)
        y = y[:, :L].reshape(B_, L, d_in)
        new_cache = (conv_tail, final_state)
    else:
        conv_state, ssd_state = cache
        conv_out, conv_tail = causal_conv(conv_in, params["conv_w"],
                                          params["conv_b"], conv_state)
        xh = conv_out[:, 0, :d_in].reshape(B_, nh, s.head_dim)
        Bh = conv_out[:, 0, d_in:d_in + gn].reshape(B_, s.n_groups, s.d_state)
        Ch = conv_out[:, 0, d_in + gn:].reshape(B_, s.n_groups, s.d_state)
        y1, new_state = ssd_decode_step(
            ssd_state.float(), xh.float(), dt[:, 0], A, Bh.float(), Ch.float(),
            params["D"])
        y = y1.reshape(B_, 1, d_in).to(x.dtype)
        new_cache = (conv_tail, new_state.to(ssd_state.dtype))

    y = _gated_norm(params["norm_scale"], y, z, cfg.norm_eps)
    return dense(params["out_proj"], y), new_cache
