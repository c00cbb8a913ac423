"""Dispatch by device: a CPU tensor takes a kernel's plain PyTorch version,
any other goes to the kernel, which launches or raises. There is no switch
and no fallback from a failed launch to the plain version."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import quantize as Q
from repro_torch.kernels import ssd_scan as SSD


def attention(q, k, v, q_pos, kv_pos, spec):
    """GQA attention (``repro.kernels.ops.attention``). On the card the
    forward is the kernel and the backward recomputes the plain version
    (``FA.FlashAttention``)."""
    if q.device.type == "cpu":
        return FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
    return FA.FlashAttention.apply(q, k, v, q_pos, kv_pos, spec)


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 256):
    """Mamba2 SSD chunked scan (``repro.kernels.ops.ssd_chunked``):
    (y [b,l,h,p], final state [b,h,p,n]). On the card the forward is the
    kernel and the backward recomputes the plain version (``SSD.SSDScan``)."""
    if x.device.type == "cpu":
        return SSD.ssd_plain(x, dt, A, B, C, D, chunk=chunk, return_state=True)
    return SSD.SSDScan.apply(x, dt, A, B, C, D, chunk)


def absmax(*xs: torch.Tensor) -> torch.Tensor:
    """max|x| over the tensors ``xs`` as a one-element fp32 tensor on their
    device: the local scale that a compressed all-reduce agrees on with a
    MAX all-reduce (``dist.compression.compressed_psum_mean``), one over
    all the layers of a reference leaf. On the card, one absmax launch per
    tensor into a fresh device scalar, over a contiguous copy of a strided
    tensor (cuDNN may hand back a convolution's weight grad channels-last,
    and on some ranks only)."""
    if xs[0].device.type == "cpu":
        return torch.stack([Q.absmax_plain(x) for x in xs]).amax().reshape(1)
    acc = Q.new_absmax(xs[0].device)
    for x in xs:
        Q.absmax_into(x.contiguous(), acc)
    return acc


def quantize_with(x: torch.Tensor, absmax: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, 0-d fp32 scale = absmax / 127) of x against a given
    max-abs, such as the MAX all-reduce of every rank's ``absmax``. On the
    card, one quantize launch (of a contiguous copy of a strided x)."""
    if x.device.type == "cpu":
        return Q.quantize_plain(x, absmax)
    return Q.quantize_with(x.contiguous(), absmax)


def quantize_int8_shared(xs: Sequence[torch.Tensor]
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Symmetric max-abs int8 of several tensors on ONE scale, the max-abs
    over all of them (``absmax``): (int8 values per tensor, 0-d fp32
    scale). On the card, one absmax launch per tensor into one device
    scalar, then one quantize launch per tensor."""
    amax = absmax(*xs)
    out = [quantize_with(x, amax) for x in xs]
    return [q for q, _ in out], out[0][1]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale) of one tensor
    (``repro.dist.compression.quantize_int8``)."""
    (q,), scale = quantize_int8_shared([x])
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return Q.dequantize_plain(q, scale)
    return Q.dequantize_int8(q, scale)
