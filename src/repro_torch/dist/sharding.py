"""The sharding-strategy registry and each strategy's collectives, as data
(``repro.dist.sharding``: ``Strategy``, ``STRATEGIES``, ``resolve_strategy``,
``CollectiveDesc``, ``STRATEGY_COLLECTIVES``, copied), and a mesh of
``torch.distributed`` process groups with the spec helpers the sharded
LeNet iteration uses (``Mesh``, ``spec_entries``, ``gather_to_full``,
``shard_of_full``). The cost model (``repro_torch.perf.costmodel``) prices
the descriptions. The logical-rule resolution and the streamed gathers of
the reference module are not ported yet.

A spec is a tuple with one entry per dim: ``None`` (replicated), a mesh-axis
name, or a tuple of names (the dim split over their product, major first) —
the reference's ``PartitionSpec``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

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


# ---------------------------------------------------------------------------
# Mesh of process groups and the spec helpers
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[Candidate], ...]


class Mesh:
    """Named axes over ranks ``0 .. size-1`` of the default process group,
    laid out major axis first (for axes (data, model): rank = d·|model| + m),
    as the reference reshapes its devices into ``Mesh(devs.reshape(...))``.

    ``group(axes)`` is the process group of the ranks that share this rank's
    index on every other axis, ``None`` when the axes span one rank (a
    collective over it is the identity). The groups come from ``groups``, a
    dict keyed by rank tuple that ``make_groups`` fills."""

    def __init__(self, axes: Mapping[str, int], rank: int,
                 groups: Mapping[Tuple[int, ...], dist.ProcessGroup]):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        self.size = mesh_size(self.shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        self.rank = rank
        self._groups = groups
        self.coords = _coords(self.shape, rank)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis``."""
        return self.coords[axis]

    def group(self, axes: Union[str, Sequence[str]]
              ) -> Optional[dist.ProcessGroup]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ranks = _group_ranks(self.shape, axes, self.coords)
        return None if len(ranks) == 1 else self._groups[ranks]


def mesh_size(axes: Mapping[str, int]) -> int:
    n = 1
    for size in axes.values():
        n *= size
    return n


def _coords(shape: Mapping[str, int], rank: int) -> Dict[str, int]:
    coords = {}
    for a in reversed(tuple(shape)):
        coords[a] = rank % shape[a]
        rank //= shape[a]
    return {a: coords[a] for a in shape}


def _group_ranks(shape: Mapping[str, int], axes: Sequence[str],
                 coords: Mapping[str, int]) -> Tuple[int, ...]:
    """The ranks that share ``coords`` on every axis but ``axes``."""
    out = []
    for c in itertools.product(*(range(shape[a]) for a in axes)):
        at = {**coords, **dict(zip(axes, c))}
        r = 0
        for a in shape:
            r = r * shape[a] + at[a]
        out.append(r)
    return tuple(sorted(out))


def make_groups(axes: Mapping[str, int],
                groups: Dict[Tuple[int, ...], dist.ProcessGroup]) -> None:
    """Make every process group a ``Mesh`` of ``axes`` can ask for (each
    non-empty combination of its axes, at each index of the others) that
    ``groups`` lacks. Collective over the default group: every rank of the
    world calls it with the same ``axes`` and an equal ``groups`` dict, since
    ``new_group`` wants every rank of the world, members or not.
    (``use_local_synchronization=True`` hangs in gloo's rendezvous once two
    ranks of a new group have made different groups before.)"""
    names = tuple(axes)
    shape = dict(axes)
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            for r in range(mesh_size(shape)):
                ranks = _group_ranks(shape, sub, _coords(shape, r))
                if len(ranks) > 1 and ranks not in groups:
                    groups[ranks] = dist.new_group(list(ranks))


def spec_entries(spec: Spec, ndim: int) -> Tuple:
    """Spec entries padded with None to ``ndim`` dims."""
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


def _axes_of(entry) -> Tuple[str, ...]:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def all_reduce(x: torch.Tensor, op: str,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Functional all-reduce of ``x`` (``op`` "sum" or "max") over
    ``group``; ``x`` itself on a single rank (``group`` None)."""
    if group is None:
        return x
    return funcol.all_reduce(x, op, group)


def gather_to_full(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """All-gather this rank's block of a tensor sharded by ``spec`` up to
    the full tensor: one tiled all-gather per axis of each sharded dim,
    minor axis first (so block order matches the major-first layout).

    Each gather runs along dim 0 of the block with the sharded dim moved
    to the front (dynamo does not trace torch 2.11's gather along another
    dim), on a host copy of a CUDA block (gloo's all-gather segfaults on
    CUDA tensors in torch 2.11): the bytes on the wire are the block's, as
    in the priced all-gather."""
    for dim, entry in enumerate(spec_entries(spec, x.ndim)):
        if entry is None:
            continue
        for a in reversed(_axes_of(entry)):
            group = mesh.group(a)
            if group is None:
                continue
            block = x.movedim(dim, 0).contiguous()
            full = funcol.all_gather_tensor(block.cpu(), 0, group)
            x = full.to(x.device).movedim(0, dim)
    return x


def shard_of_full(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full tensor under ``spec``: the inverse of
    ``gather_to_full`` (a view; ``.clone()`` it to own the block)."""
    for dim, entry in enumerate(spec_entries(spec, x.ndim)):
        if entry is None:
            continue
        idx, prod = 0, 1
        for a in _axes_of(entry):                      # major axis first
            idx = idx * mesh.shape[a] + mesh.index(a)
            prod *= mesh.shape[a]
        block = x.shape[dim] // prod
        x = x.narrow(dim, idx * block, block)
    return x
