"""The sharding-strategy registry and each strategy's collectives, as data
(``repro.dist.sharding``: ``Strategy``, ``STRATEGIES``, ``resolve_strategy``,
``CollectiveDesc``, ``STRATEGY_COLLECTIVES``, copied). The cost model
(``repro_torch.perf.costmodel``) prices these descriptions; the mesh and
partition-spec half of the reference module is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

# rules[logical] is an ordered fallback list of candidates; a candidate is
# one mesh-axis name or a tuple of names (joint sharding of one dim).
Candidate = Union[str, Tuple[str, ...]]


@dataclass(frozen=True)
class Strategy:
    """Named parallelism strategy: logical axis -> mesh-axis candidates.

    ``rules[logical]`` is tried in order; the first candidate whose mesh
    axes are all present, unused by earlier dims of the same array, and
    size-compatible with the dimension wins.
    """
    name: str
    rules: Mapping[str, Tuple[Candidate, ...]] = field(default_factory=dict)
    description: str = ""

    def candidates(self, logical: Optional[str]) -> Tuple[Candidate, ...]:
        if logical is None:
            return ()
        return tuple(self.rules.get(logical, ()))


STRATEGIES: Dict[str, Strategy] = {
    "dp": Strategy("dp", rules={}, description=(
        "Pure data parallelism: parameters replicated, batch sharded; "
        "gradients all-reduced every step.")),
    "fsdp": Strategy("fsdp", rules={
        "embed": ("data",), "vocab": ("data",), "mlp": ("data",),
        "expert": ("data",), "heads": ("data",), "kv_heads": ("data",),
    }, description=(
        "ZeRO-3 style: each parameter sharded along its first shardable "
        "dim over the data axis; params are all-gathered per layer.")),
    "tp": Strategy("tp", rules={
        "mlp": ("model",), "heads": ("model",), "kv_heads": ("model",),
        "expert": ("model",), "vocab": ("model",),
    }, description=(
        "Megatron tensor parallelism: hidden/head/expert/vocab dims over "
        "the model axis; activations all-reduced inside each block.")),
    "fsdp_tp": Strategy("fsdp_tp", rules={
        "embed": ("data",),
        "mlp": ("model",), "heads": ("model",), "kv_heads": ("model",),
        "expert": ("model",),
        "vocab": ("model", "data"),
    }, description=(
        "2-D sharding: tensor-parallel over model, parameter (ZeRO) "
        "sharding of the remaining embed dim over data.")),
}


def resolve_strategy(strategy: Union[str, Strategy]) -> Strategy:
    if isinstance(strategy, Strategy):
        return strategy
    try:
        return STRATEGIES[strategy]
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"have {sorted(STRATEGIES)}") from None


@dataclass(frozen=True)
class CollectiveDesc:
    """One abstract collective a strategy issues per training iteration:
    which ring primitive (``op``) moves which tensor class (``tensor``:
    "grad" wire-compressed, "param" fp32, "act" batch-sharded over the data
    axis) over which mesh axis (``axis``), ``count`` times. The cost model
    binds it to byte counts and per-axis device counts."""
    op: str
    tensor: str
    axis: str
    count: int = 1


# The canonical per-iteration schedules:
#   dp       ring all-reduce of the wire-compressed gradients.
#   fsdp     ZeRO-3: all-gather the fp32 parameter shards for forward and
#            again for backward, reduce-scatter compressed gradients.
#   tp       Megatron: two activation all-reduces forward and two backward
#            per tensor-parallel block; parameter gradients stay local.
#   fsdp_tp  the 2-D mesh per axis: fsdp's gather/scatter pattern on each
#            model rank's 1/|model| slice over data, plus the Megatron
#            activation all-reduces over model.
STRATEGY_COLLECTIVES: Dict[str, Tuple[CollectiveDesc, ...]] = {
    "dp": (
        CollectiveDesc("all_reduce", "grad", "data"),
    ),
    "fsdp": (
        CollectiveDesc("all_gather", "param", "data", count=2),
        CollectiveDesc("reduce_scatter", "grad", "data"),
    ),
    "tp": (
        CollectiveDesc("all_reduce", "act", "model", count=4),
    ),
    "fsdp_tp": (
        CollectiveDesc("all_gather", "param", "data", count=2),
        CollectiveDesc("reduce_scatter", "grad", "data"),
        CollectiveDesc("all_reduce", "act", "model", count=4),
    ),
}
if set(STRATEGY_COLLECTIVES) != set(STRATEGIES):
    raise AssertionError("every registry strategy needs a collective description")
