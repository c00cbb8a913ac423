"""The sharding-strategy registry and each strategy's collectives, as data
(``repro.dist.sharding``: ``Strategy``, ``STRATEGIES``, ``resolve_strategy``,
``CollectiveDesc``, ``STRATEGY_COLLECTIVES``, copied), the logical-axis
resolution (``BATCH_AXES``, ``axis_sizes``, ``logical_to_pspec``,
``param_pspecs``, ``batch_pspec``, ``spec_to_json``), the block arithmetic
of sharded checkpoints (``spec_from_json``, ``shard_grid``,
``shard_coord``, ``assemble_shards``, ``assemble_region``, copied, and
``shard_region``), the activation constraints (``BATCH``,
``resolve_constraint``, ``maybe_constrain``) and ``param_shardings``, and a
mesh of ``torch.distributed`` process groups with the helpers of the manual
(shard_map) paths: ``Mesh``, ``spec_entries``, ``gather_to_full``,
``shard_of_full``, ``manual_mode`` (the mesh the layer code's Megatron
collectives run over, and the overlap step's streaming context) and
``stream_gather`` (a per-layer all-gather whose backward is the compressed
reduce-scatter). Every eager collective of the port ends in ``_waited``,
which ``record_collectives`` listens at (the dry-run's collective terms).
The cost model (``repro_torch.perf.costmodel``) prices the collective
descriptions.

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
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

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

class _BatchSentinel:
    """Logical marker for 'the batch dimension' in activation constraints."""

    def __repr__(self):
        return "BATCH"


BATCH = _BatchSentinel()

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


class NamedSharding(NamedTuple):
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: Tuple


def param_shardings(params, mesh, strategy: Union[str, Strategy]):
    """``param_pspecs``, each spec paired with ``mesh``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda p, spec: NamedSharding(mesh, spec), params,
                    param_pspecs(params, mesh, strategy))


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


def resolve_constraint(shape: Sequence[int], entries: Sequence, mesh) -> Tuple:
    """The spec the reference's ``maybe_constrain(x, *entries)`` puts on an
    array of ``shape`` under ``mesh``: ``entries`` align with the leading
    dims (missing trailing entries mean replicated); each is None, ``BATCH``
    (the mesh's pod/data axes that divide the dim, greedily), a mesh-axis
    name or a tuple of names. Axes absent from the mesh, already used by an
    earlier dim, or not dividing the dim are dropped."""
    sizes = axis_sizes(mesh)
    used: set = set()
    padded = tuple(entries) + (None,) * (len(shape) - len(entries))
    resolved = []
    for dim, e in zip(shape, padded):
        dim = int(dim)
        if e is None:
            resolved.append(None)
            continue
        if isinstance(e, _BatchSentinel):
            entry = _batch_entry(sizes, used, dim)
        else:
            cand_axes = _axes_of(e)
            ok = _fits(cand_axes, sizes, used, dim)
            entry = ((cand_axes if len(cand_axes) > 1 else cand_axes[0])
                     if ok else None)
        if entry is not None:
            used.update(_axes_of(entry))
        resolved.append(entry)
    return _trim(resolved)


def maybe_constrain(x: torch.Tensor, *entries) -> torch.Tensor:
    """``x`` itself. The reference puts ``resolve_constraint``'s spec on
    ``x`` inside a GSPMD program; every program of the port is manual (a
    rank computes on its own slices, each collective written out), where
    the reference's ``maybe_constrain`` is the identity too."""
    return x


def spec_to_json(spec) -> list:
    """JSON-friendly entries: None | "axis" | ["axis", ...]."""
    return [None if e is None else list(e) if isinstance(e, tuple) else str(e)
            for e in tuple(spec)]


# The sharded checkpoint format (``train.checkpoint``) records every leaf's
# spec in its sidecar, so a restore can reassemble a tensor from the blocks
# written under any (mesh, strategy) and cut it again under any other.

def spec_from_json(entries) -> Tuple:
    """Inverse of ``spec_to_json``."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def shard_grid(spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """Blocks per dim a tensor splits into under ``spec`` on ``mesh``. A dim
    whose mesh-axes product does not divide it counts as unsharded (grid 1),
    as the resolver skips such a candidate."""
    sizes = axis_sizes(mesh)
    grid = []
    for dim, entry in zip(shape, spec_entries(spec, len(shape))):
        dim = int(dim)
        if entry is None:
            grid.append(1)
            continue
        prod = 1
        for a in _axes_of(entry):
            prod *= int(sizes.get(a, 1))
        grid.append(prod if prod > 0 and dim % prod == 0 else 1)
    return tuple(grid)


def shard_coord(index: Sequence, shape: Sequence[int],
                grid: Sequence[int]) -> Tuple[int, ...]:
    """Grid coordinate of a block from its global-index slices: positional in
    the global tensor, so assembly does not depend on which mesh axis (or
    axis order, for a jointly sharded dim) made the block."""
    coord = []
    for sl, dim, g in zip(tuple(index) + (slice(None),) * len(grid), shape, grid):
        start = 0 if sl.start is None else int(sl.start)
        block = int(dim) // int(g)
        coord.append(start // block if block else 0)
    return tuple(coord)


def shard_region(spec, shape: Sequence[int], mesh: "Mesh") -> Tuple[slice, ...]:
    """The global slices of this rank's block under ``spec`` (the region
    ``shard_of_full`` cuts)."""
    region = []
    for dim, entry in zip(shape, spec_entries(spec, len(shape))):
        dim = int(dim)
        if entry is None:
            region.append(slice(0, dim))
            continue
        idx, prod = 0, 1
        for a in _axes_of(entry):                      # major axis first
            idx = idx * mesh.shape[a] + mesh.index(a)
            prod *= mesh.shape[a]
        block = dim // prod
        region.append(slice(idx * block, (idx + 1) * block))
    return tuple(region)


def assemble_shards(blocks: Mapping[Tuple[int, ...], object],
                    shape: Sequence[int], grid: Sequence[int]):
    """Stitch a ``{grid coordinate: block}`` map back into the full array
    (numpy): the host-side inverse of sharding under any spec."""
    import numpy as np

    shape = tuple(int(s) for s in shape)
    grid = tuple(int(g) for g in grid)
    if all(g == 1 for g in grid):
        return np.asarray(blocks[(0,) * len(shape) if shape else ()])
    sample = next(iter(blocks.values()))
    full = np.empty(shape, dtype=np.asarray(sample).dtype)
    for coord, blk in blocks.items():
        blk = np.asarray(blk)
        slices = tuple(slice(c * (dim // g), (c + 1) * (dim // g))
                       for c, dim, g in zip(coord, shape, grid))
        if blk.shape != tuple(dim // g for dim, g in zip(shape, grid)):
            raise ValueError(f"shard block {blk.shape} does not tile "
                             f"{shape} on grid {grid}")
        full[slices] = blk
    return full


def assemble_region(blocks: Mapping[Tuple[int, ...], object],
                    shape: Sequence[int], grid: Sequence[int],
                    region: Sequence[slice]):
    """Stitch only the sub-array at ``region`` (per-dim global slices; None
    bounds mean the whole dim, trailing dims may be left out) from the
    ``{grid coordinate: block}`` map, reading only the blocks it overlaps:
    ``blocks`` needs only ``__getitem__``, so a lazy mapping defers reading
    the others."""
    import numpy as np

    shape = tuple(int(s) for s in shape)
    grid = tuple(int(g) for g in grid)
    if not shape:
        return np.asarray(blocks[()])
    region = tuple(region) + (slice(None),) * (len(shape) - len(region))
    bounds = []
    for dim, sl in zip(shape, region):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        bounds.append((max(start, 0), min(stop, dim)))
    out_shape = tuple(max(e - s, 0) for s, e in bounds)
    block_dims = tuple(d // g for d, g in zip(shape, grid))
    if 0 in out_shape:
        probe = np.asarray(blocks[(0,) * len(shape)])
        return np.empty(out_shape, dtype=probe.dtype)
    lo = tuple(s // b for (s, _), b in zip(bounds, block_dims))
    hi = tuple((e - 1) // b for (_, e), b in zip(bounds, block_dims))
    out = None
    for offset in np.ndindex(*[h - l + 1 for l, h in zip(lo, hi)]):
        coord = tuple(l + o for l, o in zip(lo, offset))
        blk = np.asarray(blocks[coord])
        if blk.shape != block_dims:
            raise ValueError(f"shard block {blk.shape} does not tile "
                             f"{shape} on grid {grid}")
        if out is None:
            out = np.empty(out_shape, dtype=blk.dtype)
        src, dst = [], []
        for (s, e), c, b in zip(bounds, coord, block_dims):
            gs = c * b
            is_, ie = max(s, gs), min(e, gs + b)
            src.append(slice(is_ - gs, ie - gs))
            dst.append(slice(is_ - s, ie - s))
        out[tuple(dst)] = blk[tuple(src)]
    return out


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


class LazyGroups(dict):
    """A ``Mesh``'s groups made as the rank first asks for each: for a
    traced rank of a world on the ``"fake"`` backend (the dry-run), where
    making every group of a 512-rank mesh up front would make hundreds the
    rank never uses. ``new_group`` needs a world: without one, asking for a
    group of more than one rank raises."""

    def __missing__(self, ranks):
        if not dist.is_initialized():
            raise RuntimeError(f"the group {ranks} needs a torch.distributed "
                               "world, and none is initialised")
        group = self[ranks] = dist.new_group(list(ranks))
        return group


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


class CollectiveRecord(NamedTuple):
    """One collective a rank issued: its kind (the reference's HLO names:
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all"), the ranks
    of its group and its bytes under the reference's rule
    (``repro.perf.hlo_analysis``): max(operand, output) bytes, times 2 for
    an all-reduce (a ring's reduce-scatter and all-gather) and 1
    otherwise."""
    kind: str
    group_size: int
    bytes: float


_RECORDERS: List[List[CollectiveRecord]] = []


@contextmanager
def record_collectives():
    """A list that every eager collective issued inside appends its
    ``CollectiveRecord`` to (nested recorders each get every record).
    ``shard_of_full`` is a view and moves nothing, so it records nothing."""
    log: List[CollectiveRecord] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _waited(t: torch.Tensor, kind: Optional[str] = None,
            operand: Optional[torch.Tensor] = None,
            group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """A functional collective's result, waited for: eagerly, funcol hands
    back an ``AsyncCollectiveTensor`` whose collective is still in flight
    on gloo's worker threads until an op needs its values (views do not),
    so a result that is dropped, or only viewed, is never waited and its
    work outlives the code that issued it; every eager collective of the
    port ends here instead. Under ``torch.compile`` the traced collective
    is already a plain tensor with its wait in the graph. With ``kind``,
    ``operand`` and ``group`` given, the collective is recorded in every
    open ``record_collectives`` list."""
    if isinstance(t, funcol.AsyncCollectiveTensor):
        t = t.wait()
    if _RECORDERS and kind is not None:
        size = max(_nbytes(operand), _nbytes(t))
        rec = CollectiveRecord(kind, dist.get_world_size(group),
                               (2.0 if kind == "all-reduce" else 1.0) * size)
        for log in _RECORDERS:
            log.append(rec)
    return t


def all_reduce(x: torch.Tensor, op: str,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Functional all-reduce of ``x`` (``op`` "sum" or "max") over
    ``group``, waited for; ``x`` itself on a single rank (``group`` None)."""
    if group is None:
        return x
    return _waited(funcol.all_reduce(x, op, group), "all-reduce", x, group)


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
            block = x.movedim(dim, 0).contiguous().cpu()
            full = _waited(funcol.all_gather_tensor(block, 0, group),
                           "all-gather", block, group)
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
