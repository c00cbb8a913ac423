"""Dispatch by device: a CPU tensor takes a kernel's plain PyTorch version,
any other goes to the kernel, which launches or raises. There is no switch
and no fallback from a failed launch to the plain version."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as FA


def attention(q, k, v, q_pos, kv_pos, spec):
    """GQA attention forward (``repro.kernels.ops.attention``)."""
    if q.device.type == "cpu":
        return FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
    return FA.flash_attention(q, k, v, q_pos, kv_pos, spec)
