"""Oracles for the kernels (small-shape ground truth), as in ``repro.kernels.ref``."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.ssd_scan import ssd_plain


def attention_ref(q, k, v, q_pos, kv_pos, spec):
    """O(Sq·Skv) reference attention, computed in fp32."""
    return attention_plain(q.float(), k.float(), v.float(), q_pos, kv_pos, spec)


def ssd_ref(x, dt, A, B, C, D, chunk: int = 64):
    """Chunked SSD reference, returns (y, final_state)."""
    return ssd_plain(x, dt, A, B, C, D, chunk=chunk, return_state=True)
