"""Whole-program cost of a traced step from the ops it dispatches: the
port's counterpart of ``repro.perf.hlo_analysis``, which walks the
reference's optimized HLO text.

The port has no compiled whole-program artifact to read: its programs are
eager, one manual program per rank. ``trace_costs`` runs the step once
(under ``FakeTensorMode`` in the dry-run, so nothing is allocated or
computed) and counts what every dispatched op would do:

* flops: the dots only, as ``torch.utils.flop_counter`` counts them (mm,
  bmm, addmm, baddbmm, convolution and its backward), which is the
  reference's rule (``hlo_analysis``: dots and convolutions, 2·out·K).
  The port's two custom ops are opaque to that counter, so each gets a
  formula (``flash_attention_flops``, ``ssd_scan_flops``) that counts the
  dots of the reference's jnp path for the same call. Their backward is the
  plain recompute (``kernels.flash_attention.plain_grads``,
  ``kernels.ssd_scan.plain_grads``): its dots dispatch as ordinary ops and
  are counted as they run, recompute included.
* bytes: output bytes + operand bytes of every op that is not a view (nor a
  collective's wait), the traffic of the port's eager, unfused program: each
  elementwise op reads its inputs from memory and writes its output. This
  is not XLA's count, which is of the fused program's top-level ops
  (fusion internals excluded), so the port's figure is the larger one.
* collectives: every eager collective of the port, recorded where it is
  waited for (``dist.sharding.record_collectives``) with the reference's
  bytes rule: max(operand, output) bytes, × 2 for an all-reduce.
* peak bytes: the most bytes that storages made during the step held at
  once (each counted from the op that made it until it is freed), the
  step's temporaries beside its arguments: XLA's ``temp_size_in_bytes``.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary


def flash_attention_flops(q, k, v, q_pos, kv_pos, causal, window, logit_softcap,
                          scale, out_shape=None) -> int:
    """Dots of one ``repro_torch::flash_attention`` forward, q [B, Sq, Hq,
    hd] against k, v [B, Skv, Hkv, hd]: 4·B·Hq·Sq·Skv·hd.

    The reference's jnp path (``repro.models.attention.attend_blockwise``,
    ``attend_naive`` when Skv fits one block) takes two einsums over every
    (query, key) pair, masked or not: the scores "bqkgh,btkh->bkgqt" (2·B·
    Hq·Sq·Skv·hd: Hq = Hkv·G outputs of Sq·Skv, each a dot of hd) and the
    weighted values "bkgqt,btkh->bkgqh" (the same). Its blocked loop pads
    Sq and Skv up to a multiple of the block (``attn_block``) where Skv
    exceeds it; the formula counts no padding, which is exact where the
    block divides both (4096 and 32768 at the default 1024)."""
    B, Sq, Hq, hd = q
    return 4 * B * Hq * Sq * k[1] * hd


def ssd_scan_flops(x, dt, A, B, C, D, chunk, out_shape=None) -> int:
    """Dots of one ``repro_torch::ssd_scan`` forward, x [b, l, h, p], B and
    C [b, l, g, n], chunks of Q = ``chunk``: 2·b·l·h·(Q·(n + p) + 2·p·n).

    The reference's jnp path (``repro.models.ssm.ssd_reference``) contracts
    four times: the intra-chunk scores "bcqhn,bckhn->bchqk" (2·b·l·h·Q·n),
    their product with the values over the chunk's keys (2·b·l·h·Q·p), the
    chunk states over the chunk's positions (2·b·l·h·p·n) and the
    inter-chunk output over the state (2·b·l·h·p·n). Its three- and
    four-operand einsums also multiply by dt and the decays on the way;
    where XLA emits such a product as a dot with no contracted dim, the
    reference counts 2·(its output) more: the scores times dt (2·b·l·h·Q)
    and at most three products of b·l·h·n or b·l·h·p elements each. So the
    formula is below the reference's count of the op's forward by at most
    ``ssd_scan_rank1_bound`` of itself: 5.2 % at Q = 32, n = p = 16, and
    1.0 % at mamba2-370m's Q = 256, n = 128, p = 64."""
    b, l, h, p = x
    n = B[3]
    return 2 * b * l * h * (chunk * (n + p) + 2 * p * n)


def ssd_scan_rank1_bound(chunk: int, n: int, p: int) -> float:
    """The fraction of ``ssd_scan_flops`` that the reference's rank-one
    products can add: (Q + 3·max(n, p)) / (Q·(n + p) + 2·p·n)."""
    return (chunk + 3 * max(n, p)) / (chunk * (n + p) + 2 * p * n)


def custom_flop_formulas() -> Dict:
    """``FlopCounterMode``'s ``custom_mapping`` for the port's custom ops
    (importing the kernels' modules registers the ops)."""
    from repro_torch.kernels import flash_attention as FA  # noqa: F401
    from repro_torch.kernels import ssd_scan as SSD  # noqa: F401
    return {torch.ops.repro_torch.flash_attention: flash_attention_flops,
            torch.ops.repro_torch.ssd_scan: ssd_scan_flops}


def flop_counter() -> FlopCounterMode:
    """A silent ``FlopCounterMode`` that also counts the custom ops: what
    the dry-run traces with, and what a real step is held to it with."""
    return FlopCounterMode(display=False, custom_mapping=custom_flop_formulas())


_NOT_TRAFFIC = ("_c10d_functional.wait_tensor",)


class _Traffic(TorchDispatchMode):
    """Bytes in and out of every non-view op, and the live bytes of the
    storages the traced ops made (each from the op that made it until it is
    freed) with their peak. A storage first seen as an op's input existed
    before the trace (an argument, a constant) and is never counted, also
    when an in-place op hands it back."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.n_ops = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in ins:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = 0
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                n = st.nbytes()
                self._seen[st] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, n)
        if not func.is_view and str(func.overloadpacket) not in _NOT_TRAFFIC:
            self.n_ops += 1
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


@dataclass
class CompStats:
    """The reference's ``hlo_analysis.CompStats`` (flops, bytes, coll_bytes,
    coll_counts) and the traced step's ``peak_bytes``, ``n_ops`` and the
    collective records themselves."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: Dict[str, float] = field(default_factory=dict)
    peak_bytes: int = 0
    n_ops: int = 0
    collectives: list = field(default_factory=list)


@contextmanager
def trace_costs():
    """Count the ops run inside: yields a ``CompStats`` that is filled when
    the block ends."""
    from repro_torch.dist.sharding import record_collectives
    stats = CompStats()
    traffic = _Traffic()
    with record_collectives() as log, flop_counter() as flops, traffic:
        yield stats
    stats.flops = float(flops.get_total_flops())
    stats.bytes = float(traffic.bytes)
    stats.peak_bytes = int(traffic.peak)
    stats.n_ops = traffic.n_ops
    stats.collectives = list(log)
    for rec in log:
        stats.coll_bytes += rec.bytes
        stats.coll_counts[rec.kind] = stats.coll_counts.get(rec.kind, 0) + 1
