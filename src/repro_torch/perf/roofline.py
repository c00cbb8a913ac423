"""Roofline terms of a traced step (``repro.perf.roofline``).

Hardware model: NVIDIA H100 80GB HBM3, 700.00 W (the H100 SXM5 80GB of
NVIDIA's datasheet), per card:
  peak bf16 dense compute : 989.4 TFLOP/s
  HBM3 bandwidth          : 3.35 TB/s
  NVLink bandwidth        : 450 GB/s per direction (the collective term)
  across nodes            : 50 GB/s per card (400 Gb/s NDR InfiniBand)
  HBM capacity            : 80 GB

Terms, as the reference's:
  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = Σ per-rank collective traffic / LINK_BW
with flops, bytes and collective traffic those of one rank's program
(``perf.op_analysis.trace_costs``): the traced program is rank 0's, so the
terms are already per card. The collective records come from the port's
recorder (``dist.sharding.record_collectives``) in place of the optimized
HLO text the reference parses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 80GB HBM3, 700.00 W (H100 SXM5 80GB datasheet), per card.
PEAK_FLOPS = 989.4e12        # bf16 dense FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink bytes/s per direction
DCN_BW = 50e9                # bytes/s per card across nodes (400 Gb/s NDR)
HBM_PER_CHIP = 80e9          # HBM3 capacity, bytes


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    total_per_chip_bytes: float = 0.0
    ops: List[Tuple[str, float]] = field(default_factory=list)


def parse_collectives(records: Sequence) -> CollectiveStats:
    """Sum one rank's collective traffic from its recorded collectives
    (``dist.sharding.CollectiveRecord``: kind, group size, bytes with the
    ring coefficient applied)."""
    stats = CollectiveStats()
    for rec in records:
        if rec.bytes == 0:
            continue
        stats.counts[rec.kind] = stats.counts.get(rec.kind, 0) + 1
        stats.bytes_by_kind[rec.kind] = stats.bytes_by_kind.get(rec.kind, 0.0) + rec.bytes
        stats.total_per_chip_bytes += rec.bytes
        stats.ops.append((rec.kind, rec.bytes))
    return stats


@dataclass
class Roofline:
    flops: float                  # per-rank dot FLOPs
    hbm_bytes: float              # per-rank bytes accessed
    collective_bytes: float       # per-rank collective traffic
    n_chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    model_flops: float = 0.0      # 6·N·D (useful flops, whole step, global)
    bottleneck: str = ""
    t_step: float = 0.0
    useful_fraction: float = 0.0  # model_flop_time / t_step

    def finalize(self, peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                 link_bw: float = LINK_BW) -> "Roofline":
        """The three terms, the largest of them (``t_step``, a lower bound on
        the step) and its name; the rates default to the H100's."""
        self.compute_s = self.flops / peak_flops
        self.memory_s = self.hbm_bytes / hbm_bw
        self.collective_s = self.collective_bytes / link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.t_step = max(terms.values())
        if self.model_flops and self.t_step > 0:
            useful_s = (self.model_flops / self.n_chips) / peak_flops
            self.useful_fraction = useful_s / self.t_step
        return self

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "flops", "hbm_bytes", "collective_bytes", "n_chips", "compute_s",
            "memory_s", "collective_s", "bottleneck", "t_step",
            "model_flops", "useful_fraction")}


def roofline_from_trace(stats, n_chips: int, model_flops: float = 0.0,
                        **rates) -> Roofline:
    """Roofline terms of a traced rank's ``perf.op_analysis.CompStats``
    (the reference's ``roofline_from_compiled``); ``rates`` override the
    H100's (``peak_flops``, ``hbm_bw``, ``link_bw``)."""
    return Roofline(flops=stats.flops, hbm_bytes=stats.bytes,
                    collective_bytes=stats.coll_bytes, n_chips=n_chips,
                    model_flops=model_flops).finalize(**rates)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), whole step.

    For decode shapes D = global_batch tokens (one token per sequence);
    for train/prefill D = global_batch · seq_len. Serving (no backward)
    uses 2·N·D instead of 6·N·D."""
    n_active = cfg.param_count(active_only=True)
    if shape.mode == "train":
        d_tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d_tokens
    if shape.mode == "prefill":
        d_tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d_tokens
    return 2.0 * n_active * shape.global_batch          # decode: 1 tok/seq
