"""The sharding-strategy registry and each strategy's collectives, as data
(``repro.dist.sharding``: ``Strategy``, ``STRATEGIES``, ``resolve_strategy``,
``CollectiveDesc``, ``STRATEGY_COLLECTIVES``, copied), the logical-axis
resolution (``BATCH_AXES``, ``axis_sizes``, ``logical_to_pspec``,
``param_pspecs``, ``batch_pspec``, ``spec_to_json``), and a mesh of
``torch.distributed`` process groups with the helpers of the manual
(shard_map) paths: ``Mesh``, ``spec_entries``, ``gather_to_full``,
``shard_of_full``, ``manual_mode`` (the mesh the layer code's Megatron
collectives run over, and the overlap step's streaming context) and
``stream_gather`` (a per-layer all-gather whose backward is the compressed
reduce-scatter). The cost model
(``repro_torch.perf.costmodel``) prices the collective descriptions.

The reference resolves each parameter's logical axes, in its own layout
(dense kernels ``[d_in, d_out]``, every segment leaf stacked on a leading
"layers" axis, which no strategy shards). ``param_pspecs`` resolves each
port tensor in that order too (a dense ``weight`` ``[d_out, d_in]`` from
its last dim to its first) and returns the spec in the port's layout, so a
layer's spec is its stacked reference leaf's without the stacking dims.

A spec is a tuple with one entry per dim: ``None`` (replicated), a mesh-axis
name, or a tuple of names (the dim split over their product, major first) —
the reference's ``PartitionSpec``.
"""
from __future__ import annotations

import itertools
from contextlib import contextmanager
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
# Logical axes -> specs
# ---------------------------------------------------------------------------

# Mesh axes that carry the batch, outermost first.
BATCH_AXES = ("pod", "data")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``Mesh`` or a plain mapping."""
    return dict(getattr(mesh, "shape", mesh))


def _fits(cand_axes: Sequence[str], sizes: Mapping[str, int], used: set,
          dim: Optional[int]) -> bool:
    prod = 1
    for a in cand_axes:
        if a not in sizes or a in used:
            return False
        prod *= sizes[a]
    return dim is None or (prod != 0 and dim % prod == 0)


def _trim(entries) -> Tuple:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def logical_to_pspec(axes: Sequence[Optional[str]], mesh,
                     strategy: Union[str, Strategy],
                     dim_sizes: Optional[Sequence[int]] = None) -> Tuple:
    """One array's logical axes resolved to a spec, left to right: each dim
    takes the first candidate of its rule whose axes are in the mesh,
    unused by an earlier dim and (given ``dim_sizes``) divide the dim."""
    strat = resolve_strategy(strategy)
    sizes = axis_sizes(mesh)
    if dim_sizes is not None and len(dim_sizes) != len(axes):
        raise ValueError(f"dim_sizes {tuple(dim_sizes)} does not match "
                         f"axes {tuple(axes)}")
    used: set = set()
    entries = []
    for i, logical in enumerate(axes):
        dim = None if dim_sizes is None else int(dim_sizes[i])
        entry = None
        for cand in strat.candidates(logical):
            cand_axes = _axes_of(cand)
            if _fits(cand_axes, sizes, used, dim):
                used.update(cand_axes)
                entry = cand_axes if len(cand_axes) > 1 else cand_axes[0]
                break
        entries.append(entry)
    return _trim(entries)


def leaf_pspec(axes, shape: Sequence[int], mesh, strategy) -> Tuple:
    """The port-layout spec of one tensor whose logical axes ``axes``
    (``models.model.ParamAxes``) are given in the reference's layout."""
    shape = tuple(shape)
    ref_shape = shape[::-1] if axes.transposed else shape
    entries = spec_entries(logical_to_pspec(axes.names, mesh, strategy,
                                            ref_shape), len(shape))
    return _trim(entries[::-1] if axes.transposed else entries)


def param_pspecs(params, mesh, strategy: Union[str, Strategy]):
    """A tree of specs, one per tensor of the port's parameter tree, in the
    port's layout (shapes only are read)."""
    from repro_torch.models.model import param_axes
    from repro_torch.tree import tree_map
    strat = resolve_strategy(strategy)
    return tree_map(lambda p, ax: leaf_pspec(ax, p.shape, mesh, strat),
                    params, param_axes(params))


def _batch_entry(sizes: Mapping[str, int], used: set, dim: Optional[int]):
    """Greedy (pod, data) batch sharding honouring divisibility (the
    reference's ``_batch_entry``)."""
    chosen = []
    prod = 1
    for a in BATCH_AXES:
        if a not in sizes or a in used:
            continue
        if dim is not None and dim % (prod * sizes[a]) != 0:
            continue
        chosen.append(a)
        prod *= sizes[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def batch_pspec(mesh, ndim: int = 1, batch_size: Optional[int] = None) -> Tuple:
    """The spec sharding dim 0 over the mesh's batch axes."""
    entry = _batch_entry(axis_sizes(mesh), set(), batch_size)
    return (entry,) + (None,) * (ndim - 1)


def spec_to_json(spec) -> list:
    """JSON-friendly entries: None | "axis" | ["axis", ...]."""
    return [None if e is None else list(e) if isinstance(e, tuple) else str(e)
            for e in tuple(spec)]


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


def _waited(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for: eagerly, funcol hands
    back an ``AsyncCollectiveTensor`` whose collective is still in flight
    on gloo's worker threads until an op needs its values (views do not),
    so a result that is dropped, or only viewed, is never waited and its
    work outlives the code that issued it; every eager collective of the
    port ends here instead. Under ``torch.compile`` the traced collective
    is already a plain tensor with its wait in the graph."""
    if isinstance(t, funcol.AsyncCollectiveTensor):
        return t.wait()
    return t


def all_reduce(x: torch.Tensor, op: str,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Functional all-reduce of ``x`` (``op`` "sum" or "max") over
    ``group``, waited for; ``x`` itself on a single rank (``group`` None)."""
    if group is None:
        return x
    return _waited(funcol.all_reduce(x, op, group))


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
            full = _waited(funcol.all_gather_tensor(block.cpu(), 0, group))
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


# ---------------------------------------------------------------------------
# Manual-collectives mode and the streamed per-layer gather
# ---------------------------------------------------------------------------

# A module global, not a thread-local: the autograd engine reruns a
# checkpointed layer, collectives included, on its own device thread.
_MANUAL: Dict[str, object] = {"mesh": None, "batch_group": None,
                              "stream_mode": None}


@contextmanager
def manual_mode(mesh: Mesh, batch_group: Optional[dist.ProcessGroup] = None,
                stream_mode: Optional[str] = None):
    """Inside, ``axis_group`` answers for ``mesh``: the layer code's
    Megatron collectives (``LocalDim`` markers name a mesh axis) run over
    its groups (the reference's ``manual_mode``, whose shard_map binds the
    axis names). With ``stream_mode`` (the overlap step's), a layer's
    ``StreamDim`` dims gather through ``manual_stream_gather``, whose
    backward means the gradient over ``batch_group`` in that wire format.
    Re-entrant."""
    prev = dict(_MANUAL)
    _MANUAL.update(mesh=mesh, batch_group=batch_group, stream_mode=stream_mode)
    try:
        yield mesh
    finally:
        _MANUAL.update(prev)


def axis_group(axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of ``axis`` of the mesh ``manual_mode`` holds."""
    mesh = _MANUAL["mesh"]
    if mesh is None:
        raise RuntimeError(f"a collective over {axis!r} outside manual_mode: "
                           "LocalDim-marked params belong to a sharded step")
    return mesh.group(axis)


def axis_index(axis: str) -> int:
    """This rank's index on ``axis`` of the mesh ``manual_mode`` holds."""
    axis_group(axis)                                   # raises outside it
    return _MANUAL["mesh"].index(axis)


class _StreamGather(torch.autograd.Function):
    """Forward ``gather_to_full``; backward the gradient's mean over the
    batch axes in the wire format ``mode``, then this rank's block."""

    @staticmethod
    def forward(x, entries, mesh, batch_group, mode):
        return gather_to_full(x, entries, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.entries, ctx.mesh, ctx.batch_group, ctx.mode = inputs

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist.compression import compressed_psum_mean
        with torch.no_grad():
            if ctx.batch_group is not None:
                g = compressed_psum_mean(g, ctx.batch_group, ctx.mode)
            g = shard_of_full(g, ctx.entries, ctx.mesh).contiguous()
        return g, None, None, None, None


def stream_gather(entries: Spec, mesh: Mesh,
                  batch_group: Optional[dist.ProcessGroup], mode: str,
                  x: torch.Tensor) -> torch.Tensor:
    """All-gather a ZeRO-sharded leaf inside the compute it feeds (the
    reference's ``stream_gather``). The backward fuses the gradient's
    mean-reduction over ``batch_group`` in the wire format ``mode`` (none,
    bf16 or int8: error feedback cannot thread through a backward) with the
    slice back to this rank's block, the fsdp reduce-scatter; so the
    gradient that reaches the optimizer for a streamed leaf is already
    reduced and sliced. Called from each layer's body, it interleaves the
    gathers and the reductions with the layers' compute."""
    return _StreamGather.apply(x, tuple(entries), mesh, batch_group, mode)


def manual_stream_gather(entries: Spec, x: torch.Tensor) -> torch.Tensor:
    """``stream_gather`` over the mesh, batch group and wire format that
    ``manual_mode`` holds (the overlap step's)."""
    if _MANUAL["stream_mode"] is None:
        raise RuntimeError("StreamDim-marked params outside the overlap "
                           "step's manual_mode")
    return stream_gather(entries, _MANUAL["mesh"], _MANUAL["batch_group"],
                         _MANUAL["stream_mode"], x)
