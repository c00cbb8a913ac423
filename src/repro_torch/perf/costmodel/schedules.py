"""Per-strategy communication schedules, composed from ring primitives
(``repro.perf.costmodel.schedules``, copied).

This is the middle layer of the cost model: it binds the abstract
per-strategy collective descriptions owned by the distribution substrate
(``repro_torch.dist.sharding.STRATEGY_COLLECTIVES``) to concrete byte counts
and per-axis ring sizes, producing a list of ``CollectiveCall`` whose
α-β total any ``Links`` (default or calibrated) can price.

Volume rules, per tensor class (``ScheduleInputs`` carries the sizes):

  grad   parameter-gradient bytes × wire_bits/32 — gradients travel in
         the compressed wire format (repro_torch.dist.compression.WIRE_BITS);
  param  parameter bytes at fp32 — ZeRO gathers are uncompressed;
  act    activation bytes at the tensor-parallel block boundaries,
         divided by the data-axis size (the batch is sharded over data,
         so each model-axis ring moves a 1/|data| activation slice).

On the 2-D ``fsdp_tp`` mesh each model rank owns a ``1/|model|`` slice
of the parameters and ZeRO-shards *that* over the data axis, so the
data-axis gather/scatter volume scales down by the model-axis size while
the model axis adds the Megatron activation all-reduces — the mesh is
decomposed into its per-axis collectives rather than priced as one blob.

Every strategy in the registry resolves here for any device count; a
collective whose axis has one device contributes zero, so ``n_devices=1``
rows cost 0.0s and the sweep never raises for a registry strategy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

from repro_torch.dist.sharding import STRATEGY_COLLECTIVES, resolve_strategy
from repro_torch.perf.costmodel.primitives import (DEFAULT_LINK,
                                                   CollectiveCall, Links,
                                                   schedule_seconds)


@dataclass(frozen=True)
class ScheduleInputs:
    """Concrete sizes one training iteration binds a schedule to.

    ``act_bytes`` is the total fp32 activation footprint at the
    tensor-parallel block boundaries for the *global* batch (the sweep
    estimates it per LeNet config; the train driver from batch·seq·
    d_model·n_layers). Only tp-family strategies consume it.
    """
    n_devices: int
    param_bytes: int
    wire_bits: int = 32
    act_bytes: int = 0


def mesh_axes_for(strategy: Union[str, object], n_devices: int
                  ) -> Dict[str, int]:
    """Factor ``n_devices`` into the named mesh axes a strategy uses.

    dp/fsdp put everything on "data"; tp puts everything on "model";
    fsdp_tp fixes a 2-wide model axis when the count is even (the same
    small-model split the reference's elastic re-mesh planner prefers at LeNet
    scale) and gives the rest to data. Missing factors degrade to size-1
    axes, never to an error.
    """
    name = resolve_strategy(strategy).name
    n = max(int(n_devices), 1)
    if name in ("dp", "fsdp"):
        return {"data": n}
    if name == "tp":
        return {"model": n}
    if name == "fsdp_tp":
        model = 2 if n % 2 == 0 else 1
        return {"data": n // model, "model": model}
    raise ValueError(f"no mesh factoring for strategy {name!r}")


def _tensor_bytes(tensor: str, inp: ScheduleInputs,
                  axes: Dict[str, int]) -> float:
    model = axes.get("model", 1)
    data = axes.get("data", 1)
    if tensor == "grad":
        return inp.param_bytes / model * (inp.wire_bits / 32.0)
    if tensor == "param":
        return inp.param_bytes / model
    if tensor == "act":
        return inp.act_bytes / data
    raise ValueError(f"unknown tensor class {tensor!r}")


def build_schedule(strategy: Union[str, object],
                   inp: ScheduleInputs,
                   axes: Union[Dict[str, int], None] = None
                   ) -> Tuple[CollectiveCall, ...]:
    """The concrete collective calls of one training iteration.

    ``axes`` overrides the canonical factoring — the elastic re-mesh
    planner prices *candidate* (data, model) splits of a shrunken pool,
    which need not match ``mesh_axes_for``'s convention.
    """
    name = resolve_strategy(strategy).name
    if axes is None:
        axes = mesh_axes_for(name, inp.n_devices)
    calls: List[CollectiveCall] = []
    for desc in STRATEGY_COLLECTIVES[name]:
        ring = axes.get(desc.axis, 1)
        if ring <= 1:
            continue
        nbytes = _tensor_bytes(desc.tensor, inp, axes)
        if nbytes <= 0:
            continue
        calls.extend(CollectiveCall(desc.op, ring, nbytes,
                                    tensor=desc.tensor, axis=desc.axis)
                     for _ in range(desc.count))
    return tuple(calls)


def strategy_comm_seconds(strategy: Union[str, object], inp: ScheduleInputs,
                          links: Links = DEFAULT_LINK,
                          axes: Union[Dict[str, int], None] = None) -> float:
    """Per-iteration communication seconds of a strategy under ``links``."""
    return schedule_seconds(build_schedule(strategy, inp, axes=axes), links)


def exposed_comm_seconds(strategy: Union[str, object], inp: ScheduleInputs,
                         links: Links = DEFAULT_LINK, *,
                         compute_seconds: float = 0.0,
                         overlap: float = 0.0,
                         axes: Union[Dict[str, int], None] = None) -> float:
    """Communication left *exposed* after overlapping with compute.

    The overlap train step interleaves streamed parameter gathers and
    fused gradient reduce-scatters with per-layer compute, so a fraction
    of the schedule's wall-clock hides behind the math. The fitted
    per-strategy overlap factor ``overlap`` (ρ ∈ [0, 1], from
    ``Calibration.overlap_for``) prices that as

        exposed = max(0, comm − ρ·compute)

    ρ=0 degrades to the fully-serialized legacy schedule; ρ=1 means up
    to one full compute time of communication hides completely.
    """
    comm = strategy_comm_seconds(strategy, inp, links, axes=axes)
    return max(0.0, comm - float(overlap) * float(compute_seconds))


def describe_schedule(strategy: Union[str, object],
                      inp: ScheduleInputs,
                      links: Links = DEFAULT_LINK,
                      axes: Union[Dict[str, int], None] = None) -> List[Dict]:
    """JSON-friendly breakdown (the train driver's --report-comm)."""
    return [{"op": c.op, "axis": c.axis, "tensor": c.tensor,
             "ring": c.n_devices, "bytes": round(c.nbytes),
             "ms": c.seconds(links) * 1e3}
            for c in build_schedule(strategy, inp, axes=axes)]
