"""The planner's feasible launch space (``repro.perf.planner.space``).

Two layers, as the reference's:

* **generic** (any model of the registry): ``tree_shard_bytes`` resolves
  the strategy's specs with ``dist.sharding.param_pspecs`` and turns them
  into per-rank bytes, so the planner's feasibility is the registry's own
  divisibility and axis-reuse rules;
* **LeNet** (the measured sweep's subject): ``enumerate_lenet_space`` walks
  strategy × n_devices × batch × wire format and keeps the points the
  sharded iteration can run (the pool fits the trial, the global batch
  divides over the data axis), each priced by the same specs that
  iteration shards with (``perf.sweep.lenet_partition_specs``).

Memory model (per rank, the bytes the reference counts): the persistent
parameter shard, optimizer copies of it, the activations of the per-rank
sub-batch, the transient gather footprint and the full-size gradient tree.
The overlap step streams per-layer gathers, so an LM's gather term is its
eager tensors plus the largest single-layer streamed chunk
(``train.step.overlap_transient_bytes``).

The port keeps a segment's layers as separate tensors where the reference
stacks them in one leaf. Every byte count here sums a reference leaf's
tensors before it divides (``tree.reference_leaves``), so each floor
division is the reference's and the integers are its integers. Shapes come
from fake tensors (``models.model.param_shapes``): nothing is allocated.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.lenet5 import (BATCH_SIZES, DATASET_SHAPES,
                                        GRAD_COMPRESSIONS, LeNet5Config,
                                        N_CLASSES)
from repro_torch.dist.sharding import (STRATEGIES, axis_sizes, param_pspecs,
                                       resolve_strategy)
from repro_torch.perf.costmodel import mesh_axes_for

# Default planning pool sizes: the divisors of the reference's forced pool
# of 8. 8 extrapolates the fitted powers beyond the Table-1 sweep values
# {1, 2, 4}.
POOL_DEVICES = (1, 2, 4, 8)

# Persistent optimizer-state copies of the parameter shard, per optimizer,
# for the LeNet sweep step (stateless sgd; adam keeps m+v) and the LM train
# step (sgd keeps momentum; adamw m+v; adafactor factored ~0).
OPT_STATE_COPIES = {"sgd": 0.0, "adam": 2.0}
LM_OPT_STATE_COPIES = {"sgd": 1.0, "adamw": 2.0, "adafactor": 0.0}

DEFAULT_MEM_BUDGET_BYTES = 1 << 30     # 1 GiB a rank: the planning envelope

# Skip-reason sentinels (the sweep's sharded_skip vocabulary).
SKIP_POOL = "pool-too-small"
SKIP_BATCH = "batch-indivisible"
SKIP_MEMORY = "memory-infeasible"


# ---------------------------------------------------------------------------
# Generic (registry-rule) shard/memory arithmetic
# ---------------------------------------------------------------------------

def shard_divisor(spec, sizes: Mapping[str, int]) -> int:
    """How many ways a spec splits a tensor: the product of the mesh-axis
    sizes it names."""
    div = 1
    for entry in tuple(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            div *= int(sizes.get(a, 1))
    return div


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def _reference_bytes(tree, specs) -> List[Tuple[int, tuple]]:
    """(bytes, spec) per reference leaf of ``tree``: its layers' tensors
    summed (they share one spec; no strategy shards the layers axis)."""
    from repro_torch.tree import reference_leaves, tree_map
    per = []
    tree_map(lambda t, s: per.append((_leaf_bytes(t), s)), tree, specs)
    return [(sum(per[i][0] for i in idx), per[idx[0]][1])
            for _, idx in reference_leaves(tree)]


def tree_shard_bytes(params, mesh, strategy: Union[str, object],
                     pspecs=None) -> Tuple[int, int]:
    """(full_bytes, per_rank_bytes) of a parameter tree under a strategy.
    ``pspecs`` defaults to the registry's resolution (``param_pspecs``);
    pass specs (the LeNet iteration's) to price a tree sharded otherwise."""
    if pspecs is None:
        pspecs = param_pspecs(params, mesh, strategy)
    sizes = axis_sizes(mesh)
    full = shard = 0
    for b, spec in _reference_bytes(params, pspecs):
        full += b
        shard += b // shard_divisor(spec, sizes)
    return full, shard


@dataclass(frozen=True)
class MemoryEstimate:
    """Per-rank bytes of one launch point (see the module docstring)."""
    params_full_bytes: int
    params_per_device_bytes: int
    opt_copies: float
    act_per_device_bytes: int
    # The overlap body's transient gather term when the pricing knows it
    # (eager gathers + the largest single-layer streamed chunk); None falls
    # back to the legacy full-tree gather.
    gather_transient_bytes: Optional[int] = None

    @property
    def opt_per_device_bytes(self) -> int:
        return int(self.opt_copies * self.params_per_device_bytes)

    @property
    def gather_per_device_bytes(self) -> int:
        """Transient parameter-gather bytes beyond the persistent shards
        (zero under dp, whose parameters are whole on every rank)."""
        if self.gather_transient_bytes is not None:
            return self.gather_transient_bytes
        return self.params_full_bytes - self.params_per_device_bytes

    @property
    def grad_per_device_bytes(self) -> int:
        """The transient full-size gradient tree."""
        return self.params_full_bytes

    @property
    def total_per_device_bytes(self) -> int:
        return (self.params_per_device_bytes + self.opt_per_device_bytes
                + self.act_per_device_bytes + self.gather_per_device_bytes
                + self.grad_per_device_bytes)

    def headroom_bytes(self, budget_bytes: int) -> int:
        return int(budget_bytes) - self.total_per_device_bytes

    def to_dict(self) -> Dict[str, int]:
        return {"params_full": self.params_full_bytes,
                "params_per_device": self.params_per_device_bytes,
                "opt_per_device": self.opt_per_device_bytes,
                "act_per_device": self.act_per_device_bytes,
                "gather_per_device": self.gather_per_device_bytes,
                "grad_per_device": self.grad_per_device_bytes,
                "total_per_device": self.total_per_device_bytes}


def estimate_memory(params, mesh, strategy: Union[str, object], *,
                    opt_copies: float, act_per_device_bytes: int = 0,
                    pspecs=None,
                    gather_transient_bytes: Optional[int] = None
                    ) -> MemoryEstimate:
    """MemoryEstimate of a parameter tree (tensors or fake tensors) under a
    mesh and strategy: registry rules unless ``pspecs`` is given."""
    full, shard = tree_shard_bytes(params, mesh, strategy, pspecs=pspecs)
    return MemoryEstimate(params_full_bytes=full,
                          params_per_device_bytes=shard,
                          opt_copies=opt_copies,
                          act_per_device_bytes=act_per_device_bytes,
                          gather_transient_bytes=gather_transient_bytes)


def model_comm_sizes(cfg, batch: int, seq: int,
                     skeleton=None) -> Tuple[int, int]:
    """(param_bytes, act_bytes) of an LM config: the schedule inputs the
    collectives are priced with. Parameter bytes are the model's tensors
    at their dtypes, read off ``models.model.param_shapes`` (or off
    ``skeleton``, such a tree). Activations are the tp block boundaries: one
    [batch, seq, d_model] fp32 tensor per layer (what Megatron-style
    schedules all-reduce)."""
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_leaves

    if skeleton is None:
        skeleton = MD.param_shapes(cfg)
    param_bytes = sum(_leaf_bytes(x) for x in tree_leaves(skeleton))
    act_bytes = 4 * batch * seq * cfg.d_model * cfg.n_layers
    return param_bytes, act_bytes


# ---------------------------------------------------------------------------
# LeNet (measured-sweep) launch points
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchPoint:
    """One candidate launch configuration of the measured-sweep space."""
    cfg: LeNet5Config
    mesh_axes: Mapping[str, int] = field(hash=False, default=None)

    @property
    def strategy(self) -> str:
        return self.cfg.strategy

    @property
    def n_devices(self) -> int:
        return self.cfg.n_devices

    @property
    def batch_size(self) -> int:
        return self.cfg.batch_size

    @property
    def compression(self) -> str:
        return self.cfg.compression

    @property
    def wire_bits(self) -> int:
        return self.cfg.wire_bits

    def act_bytes(self) -> int:
        """Activation bytes the tp-family schedules price collectives on."""
        from repro_torch.perf.sweep import lenet_act_bytes
        return lenet_act_bytes(self.cfg)

    def key(self) -> Tuple:
        return (self.strategy, self.n_devices, self.batch_size,
                self.compression)


@dataclass(frozen=True)
class Feasibility:
    ok: bool
    reasons: Tuple[str, ...]
    memory: MemoryEstimate
    mem_headroom_bytes: int


def lenet_param_skeleton(cfg: LeNet5Config):
    """The LeNet parameters as fake tensors (shapes and dtypes only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.lenet import init_lenet
    with FakeTensorMode():
        return init_lenet(cfg, device="cpu")


def lenet_act_sample_bytes(cfg: LeNet5Config) -> int:
    """fp32 bytes of one sample's activation working set: the input image
    plus every conv/pool/dense output the forward pass holds."""
    from repro_torch.models.lenet import _conv_out, _pool_out

    h, w, c = DATASET_SHAPES[cfg.dataset]
    total = h * w * c
    for i in range(2):
        ch = cfg.n_filters if i == 0 else 2 * cfg.n_filters
        h = _conv_out(h, cfg.kernel_size, cfg.stride, cfg.padding)
        w = _conv_out(w, cfg.kernel_size, cfg.stride, cfg.padding)
        total += h * w * ch
        h = _pool_out(h, cfg.pool_size)
        w = _pool_out(w, cfg.pool_size)
        total += h * w * ch
    total += 120 + 84 + N_CLASSES
    return 4 * total


def lenet_memory(cfg: LeNet5Config,
                 mesh_axes: Optional[Mapping[str, int]] = None,
                 skeleton=None) -> MemoryEstimate:
    """Per-rank memory of one LeNet launch point, priced against the entry
    and gather specs the sharded iteration uses
    (``perf.sweep.lenet_partition_specs``): the split fc pair stays local
    and is never gathered, so it adds nothing to the gather term."""
    from repro_torch.perf.sweep import lenet_partition_specs

    axes = dict(mesh_axes if mesh_axes is not None
                else mesh_axes_for(cfg.strategy, cfg.n_devices))
    if skeleton is None:
        skeleton = lenet_param_skeleton(cfg)
    entry_specs, gather_specs, _ = lenet_partition_specs(cfg, skeleton, axes)
    gather_transient = 0
    for k, p in skeleton.items():
        b = _leaf_bytes(p)
        entry_div = shard_divisor(entry_specs[k], axes)
        gather_div = shard_divisor(gather_specs[k], axes)
        # in the body: the entry shard with its gathered dims restored
        gather_transient += b // (entry_div // gather_div) - b // entry_div
    data = axes.get("data", 1)
    per_dev_batch = max(cfg.batch_size // max(data, 1), 1)
    return estimate_memory(
        skeleton, axes, cfg.strategy, pspecs=entry_specs,
        opt_copies=OPT_STATE_COPIES.get(cfg.optimizer, 2.0),
        act_per_device_bytes=per_dev_batch * lenet_act_sample_bytes(cfg),
        gather_transient_bytes=gather_transient)


def check_feasible(cfg: LeNet5Config, *, pool: int,
                   mem_budget_bytes: int = DEFAULT_MEM_BUDGET_BYTES,
                   skeleton=None) -> Feasibility:
    """Can the sharded iteration run this point? Not when the pool is
    smaller than n_devices, when the global batch does not divide over the
    data axis, or when the per-rank memory estimate exceeds the budget.
    Parameter dims that do not divide stay unsharded and cost memory only."""
    axes = mesh_axes_for(cfg.strategy, cfg.n_devices)
    reasons: List[str] = []
    if cfg.n_devices > pool:
        reasons.append(SKIP_POOL)
    data = axes.get("data", 1)
    if data > 1 and cfg.batch_size % data != 0:
        reasons.append(SKIP_BATCH)
    mem = lenet_memory(cfg, axes, skeleton=skeleton)
    headroom = mem.headroom_bytes(mem_budget_bytes)
    if headroom < 0:
        reasons.append(SKIP_MEMORY)
    return Feasibility(ok=not reasons, reasons=tuple(reasons),
                       memory=mem, mem_headroom_bytes=headroom)


def enumerate_lenet_space(
        base: LeNet5Config, *, pool: int,
        n_devices: Sequence[int] = POOL_DEVICES,
        batches: Sequence[int] = BATCH_SIZES,
        strategies: Sequence[str] = tuple(sorted(STRATEGIES)),
        compressions: Sequence[str] = GRAD_COMPRESSIONS,
        mem_budget_bytes: int = DEFAULT_MEM_BUDGET_BYTES,
) -> Tuple[List[Tuple[LaunchPoint, Feasibility]],
           List[Tuple[LaunchPoint, Feasibility]]]:
    """(feasible, skipped) launch points over the extrinsic grid, in the
    order strategy → n_devices → batch → wire format; intrinsics pinned to
    ``base`` (so one skeleton prices the whole grid)."""
    skeleton = lenet_param_skeleton(base)
    feasible, skipped = [], []
    for strategy in strategies:
        resolve_strategy(strategy)          # fail fast on a typo
        for n in n_devices:
            for batch in batches:
                for comp in compressions:
                    cfg = dataclasses.replace(
                        base, strategy=strategy, n_devices=int(n),
                        batch_size=int(batch), compression=comp)
                    feas = check_feasible(
                        cfg, pool=pool, mem_budget_bytes=mem_budget_bytes,
                        skeleton=skeleton)
                    point = LaunchPoint(
                        cfg=cfg, mesh_axes=mesh_axes_for(strategy, int(n)))
                    (feasible if feas.ok else skipped).append((point, feas))
    return feasible, skipped


# ---------------------------------------------------------------------------
# Generic (any registry architecture) launch points
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchLaunchPoint:
    """One candidate launch configuration of an LM/MoE/SSM model, with
    ``LaunchPoint``'s surface (strategy, n_devices, batch_size,
    compression, act_bytes, key) so predict/search/report take both."""
    cfg: object                    # repro_torch.configs.base.ModelConfig
    seq_len: int
    n_devices: int
    batch_size: int
    strategy: str
    compression: str
    mesh_axes: Mapping[str, int] = field(hash=False, default=None)

    @property
    def wire_bits(self) -> int:
        from repro_torch.dist.compression import WIRE_BITS
        return WIRE_BITS[self.compression]

    def act_bytes(self) -> int:
        return 4 * self.batch_size * self.seq_len * \
            self.cfg.d_model * self.cfg.n_layers

    def key(self) -> Tuple:
        return (self.strategy, self.n_devices, self.batch_size,
                self.compression)

    # -- what the registry's seq feature extractors read off a point --------
    @property
    def family(self) -> str:
        return {"dense": "lm"}.get(self.cfg.family, self.cfg.family)

    @property
    def arch_id(self) -> str:
        return getattr(self.cfg, "name", "")

    @property
    def d_model(self) -> int:
        return self.cfg.d_model

    @property
    def n_layers(self) -> int:
        return self.cfg.n_layers

    @property
    def d_ff(self) -> int:
        return self.cfg.d_ff

    @property
    def n_experts(self) -> int:
        return self.cfg.moe.n_experts if self.cfg.moe else 0

    @property
    def top_k(self) -> int:
        return self.cfg.moe.top_k if self.cfg.moe else 0

    @property
    def d_state(self) -> int:
        return self.cfg.ssm.d_state if self.cfg.ssm else 0


# (cfg, strategy, mesh, optimizer) -> overlap transient bytes: the
# enumeration revisits one (strategy, n_devices) cell for every batch and
# wire format.
_TRANSIENT_CACHE: Dict[Tuple, int] = {}


def _model_gather_transient(cfg, strat_name: str, axes: Mapping[str, int],
                            optimizer: str) -> Optional[int]:
    """Transient gather bytes of the overlap train step for one launch
    cell (eager gathers + the largest single-layer streamed chunk). None
    when the pricing cannot run (the reference's contract: every failure
    falls back to the legacy full-tree transient)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.step import overlap_transient_bytes

    try:
        key = (cfg, strat_name, tuple(sorted(axes.items())), optimizer)
        if key in _TRANSIENT_CACHE:
            return _TRANSIENT_CACHE[key]
    except TypeError:
        key = None
    try:
        tcfg = TrainConfig(optimizer=optimizer if optimizer in
                           LM_OPT_STATE_COPIES else "sgd",
                           grad_compression="none", remat_policy="none")
        eager, chunk = overlap_transient_bytes(cfg, tcfg, dict(axes),
                                               strat_name)
        out = int(eager + chunk)
    except Exception:
        return None
    if key is not None:
        _TRANSIENT_CACHE[key] = out
    return out


def model_memory(cfg, strategy: Union[str, object], n_devices: int, *,
                 batch_size: int, seq_len: int, optimizer: str = "sgd",
                 skeleton=None) -> MemoryEstimate:
    """Per-rank memory of one LM/MoE/SSM launch point under the registry's
    specs. Activations are the tp block-boundary tensors of the per-rank
    sub-batch (as ``model_comm_sizes``); the gather term is the overlap
    step's streaming footprint, not the full tree."""
    from repro_torch.models import model as MD
    from repro_torch.perf.sweep import arch_mesh_axes

    strat_name = resolve_strategy(strategy).name
    axes = arch_mesh_axes(strat_name, n_devices)
    if skeleton is None:
        skeleton = MD.param_shapes(cfg)
    per_dev_batch = max(batch_size // max(axes.get("data", 1), 1), 1)
    act = 4 * per_dev_batch * seq_len * cfg.d_model * cfg.n_layers
    return estimate_memory(
        skeleton, axes, strategy,
        opt_copies=LM_OPT_STATE_COPIES.get(optimizer, 2.0),
        act_per_device_bytes=act,
        gather_transient_bytes=_model_gather_transient(
            cfg, strat_name, axes, optimizer))


def estimate_memory_for(cfg, strategy: Union[str, object], n_devices: int,
                        *, batch_size: int, seq_len: int = 0,
                        optimizer: str = "sgd",
                        skeleton=None) -> MemoryEstimate:
    """Per-rank memory estimate by architecture: a LeNet config through
    ``lenet_memory`` (its config carries seq/optimizer), any registry
    config through ``model_memory``."""
    if isinstance(cfg, LeNet5Config):
        cfg = dataclasses.replace(cfg,
                                  strategy=resolve_strategy(strategy).name,
                                  n_devices=int(n_devices),
                                  batch_size=int(batch_size))
        return lenet_memory(cfg, skeleton=skeleton)
    return model_memory(cfg, strategy, n_devices, batch_size=batch_size,
                        seq_len=seq_len, optimizer=optimizer,
                        skeleton=skeleton)


def check_feasible_model(cfg, strategy: str, n_devices: int, *,
                         batch_size: int, seq_len: int, pool: int,
                         optimizer: str = "sgd",
                         mem_budget_bytes: int = DEFAULT_MEM_BUDGET_BYTES,
                         skeleton=None) -> Feasibility:
    """``check_feasible`` for LM/MoE/SSM points: pool fit, global batch
    divisible over the data axis, memory within budget."""
    from repro_torch.perf.sweep import arch_mesh_axes

    axes = arch_mesh_axes(resolve_strategy(strategy).name, n_devices)
    reasons: List[str] = []
    if n_devices > pool:
        reasons.append(SKIP_POOL)
    data = axes.get("data", 1)
    if data > 1 and batch_size % data != 0:
        reasons.append(SKIP_BATCH)
    mem = model_memory(cfg, strategy, n_devices, batch_size=batch_size,
                       seq_len=seq_len, optimizer=optimizer,
                       skeleton=skeleton)
    headroom = mem.headroom_bytes(mem_budget_bytes)
    if headroom < 0:
        reasons.append(SKIP_MEMORY)
    return Feasibility(ok=not reasons, reasons=tuple(reasons),
                       memory=mem, mem_headroom_bytes=headroom)


def enumerate_space(
        base, *, pool: int, seq_len: int = 0,
        n_devices: Sequence[int] = POOL_DEVICES,
        batches: Sequence[int] = None,
        strategies: Sequence[str] = tuple(sorted(STRATEGIES)),
        compressions: Sequence[str] = None,
        optimizer: str = "sgd",
        mem_budget_bytes: int = DEFAULT_MEM_BUDGET_BYTES,
) -> Tuple[List[Tuple[object, Feasibility]],
           List[Tuple[object, Feasibility]]]:
    """(feasible, skipped) launch points of any config: LeNet through
    ``enumerate_lenet_space``; a registry config over the same grid with
    the LM wire formats, as ``ArchLaunchPoint``s priced by
    ``model_memory``."""
    if isinstance(base, LeNet5Config):
        return enumerate_lenet_space(
            base, pool=pool, n_devices=n_devices,
            batches=BATCH_SIZES if batches is None else batches,
            strategies=strategies,
            compressions=(GRAD_COMPRESSIONS if compressions is None
                          else compressions),
            mem_budget_bytes=mem_budget_bytes)
    from repro_torch.models import model as MD
    from repro_torch.perf.sweep import (ARCH_BATCH_SIZES, ARCH_COMPRESSIONS,
                                        arch_mesh_axes)

    if not seq_len:
        raise ValueError("enumerate_space needs seq_len > 0 for "
                         "sequence-model configs")
    batches = ARCH_BATCH_SIZES if batches is None else batches
    compressions = (ARCH_COMPRESSIONS if compressions is None
                    else compressions)
    skeleton = MD.param_shapes(base)
    feasible, skipped = [], []
    for strategy in strategies:
        resolve_strategy(strategy)          # fail fast on a typo
        for n in n_devices:
            for batch in batches:
                for comp in compressions:
                    feas = check_feasible_model(
                        base, strategy, int(n), batch_size=int(batch),
                        seq_len=int(seq_len), pool=pool,
                        optimizer=optimizer,
                        mem_budget_bytes=mem_budget_bytes,
                        skeleton=skeleton)
                    point = ArchLaunchPoint(
                        cfg=base, seq_len=int(seq_len), n_devices=int(n),
                        batch_size=int(batch), strategy=strategy,
                        compression=comp,
                        mesh_axes=arch_mesh_axes(strategy, int(n)))
                    (feasible if feas.ok else skipped).append((point, feas))
    return feasible, skipped
