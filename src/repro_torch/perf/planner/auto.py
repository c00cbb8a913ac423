"""`--strategy auto`: pick a registry strategy for an LM training run
(``repro.perf.planner.auto``).

At a fixed (arch, batch, seq, device count) the compute term is nearly
strategy-independent — what differs between dp/fsdp/tp/fsdp_tp is the
collective schedule and the per-device memory footprint. The chooser
therefore ranks the full strategy registry by the calibrated collective
cost (``perf.predict.estimate_comm``), subject to feasibility:

  * the global batch must divide over the batch axes of the run's mesh
    (``train.step.sharded_batch_ok``);
  * the per-rank memory estimate (the registry's sharding of the
    parameter shapes, ``dist.sharding.param_pspecs``) must fit the budget.

Ties in comm cost (e.g. several strategies costing ~0 on one device)
break toward the larger memory headroom.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.dist.sharding import STRATEGIES
from repro_torch.perf.costmodel import Calibration, mesh_axes_for
from repro_torch.perf.planner.space import (DEFAULT_MEM_BUDGET_BYTES,
                                            LM_OPT_STATE_COPIES,
                                            estimate_memory, model_comm_sizes)
from repro_torch.perf.predict import estimate_comm

from repro_torch.perf.planner.predict import UNCALIBRATED_NOTE


@dataclass(frozen=True)
class StrategyDecision:
    strategy: str
    reason: str
    comm_ms: float
    mem_headroom_bytes: int
    calibration_label: str
    candidates: Tuple[Dict, ...]        # full ranking, for the dry-run plan

    @property
    def calibrated(self) -> bool:
        return self.calibration_label != "default"

    def to_dict(self) -> Dict:
        out = {"strategy": self.strategy, "reason": self.reason,
               "comm_ms": self.comm_ms,
               "mem_headroom_bytes": self.mem_headroom_bytes,
               "calibration": self.calibration_label,
               "candidates": list(self.candidates)}
        if not self.calibrated:
            out["note"] = UNCALIBRATED_NOTE
        return out


def choose_strategy(cfg, *, batch: int, seq: int, n_devices: int,
                    optimizer: str = "adamw", compression: str = "none",
                    mem_budget_bytes: int = DEFAULT_MEM_BUDGET_BYTES,
                    calibration: Optional[Calibration] = None,
                    mesh_axes: Optional[Dict[str, int]] = None
                    ) -> StrategyDecision:
    """Rank every registry strategy for this run; return the winner.

    ``mesh_axes`` is the mesh the run will actually build (the train
    driver passes ``plan_remesh``'s factorization) — feasibility (batch
    divisibility, per-device memory under ``param_pspecs``) is judged
    on it. Communication is priced on the cost model's canonical
    per-strategy factoring (``mesh_axes_for``) — the same simulation
    convention the sweep and the calibration use.
    """
    from repro_torch.dist.compression import WIRE_BITS
    from repro_torch.models import model as MD
    from repro_torch.perf.costmodel import load_calibration
    from repro_torch.train.step import sharded_batch_ok

    skeleton = MD.param_shapes(cfg)
    param_bytes, act_bytes = model_comm_sizes(cfg, batch, seq,
                                              skeleton=skeleton)
    opt_copies = LM_OPT_STATE_COPIES.get(optimizer, 2.0)
    cal = calibration if calibration is not None else load_calibration()

    rows: List[Dict] = []
    label = "default"
    for name in sorted(STRATEGIES):
        run_axes = dict(mesh_axes) if mesh_axes is not None \
            else mesh_axes_for(name, n_devices)
        comm = estimate_comm(name, n_devices, param_bytes,
                             wire_bits=WIRE_BITS[compression],
                             act_bytes=act_bytes, calibration=cal)
        label = comm.calibration_label
        # activations shard over the data axis only; a strategy whose
        # mesh has no data axis (tp) replicates the full batch per device
        data = run_axes.get("data", 1)
        mem = estimate_memory(skeleton, run_axes, name,
                              opt_copies=opt_copies,
                              act_per_device_bytes=act_bytes
                              // max(data, 1))
        headroom = mem.headroom_bytes(mem_budget_bytes)
        reasons = []
        if not sharded_batch_ok(run_axes, batch):
            reasons.append(f"batch {batch} not divisible over the batch "
                           f"axes of mesh {dict(run_axes)}")
        if headroom < 0:
            reasons.append(f"memory estimate exceeds budget by "
                           f"{-headroom / 2**20:.0f}MB")
        rows.append({"strategy": name, "feasible": not reasons,
                     "why_not": "; ".join(reasons) or None,
                     "comm_ms": comm.seconds * 1e3,
                     "mesh_axes": dict(run_axes),
                     "mem_per_device_bytes": mem.total_per_device_bytes,
                     "mem_headroom_bytes": headroom})

    feasible = [r for r in rows if r["feasible"]]
    pool = feasible or rows          # nothing feasible: least-bad overall
    best = min(pool, key=lambda r: (r["comm_ms"],
                                    -r["mem_headroom_bytes"]))
    if feasible:
        reason = (f"cheapest calibrated collective schedule "
                  f"({best['comm_ms']:.3f} ms/step) among "
                  f"{len(feasible)}/{len(rows)} feasible strategies")
    else:
        reason = ("no strategy fully feasible; least-bad by comm cost "
                  f"({best['why_not']})")
    return StrategyDecision(
        strategy=best["strategy"], reason=reason,
        comm_ms=best["comm_ms"],
        mem_headroom_bytes=best["mem_headroom_bytes"],
        calibration_label=label,
        candidates=tuple(sorted(rows, key=lambda r: r["comm_ms"])))


def remesh_predict(cfg, strategy: str, *, batch: int, seq: int,
                   optimizer: str = "adamw", compression: str = "none",
                   mem_budget_bytes: int = DEFAULT_MEM_BUDGET_BYTES,
                   calibration: Optional[Calibration] = None,
                   compute_ref: Optional[Tuple[float, int]] = None):
    """Build the ``predict(data, model) -> seconds`` hook that the
    reference's ``train.ft.plan_remesh`` ranks candidate meshes with: the
    fitted performance model made pluggable into recovery (its port's
    caller comes with ``plan_remesh``'s ``predict`` option).

    Each candidate ``{"data": d, "model": m}`` split is priced as the
    calibrated collective schedule of ``strategy`` on those *explicit*
    axes (``strategy_comm_seconds(..., axes=...)``, not the canonical
    factoring — a shrunken pool rarely matches it) plus a compute term:
    ``compute_ref = (seconds, data_width)`` is a measured per-step time
    at a reference data-axis width, scaled as ``seconds * ref_d / d``
    (per-device work grows as the batch concentrates on fewer ranks).
    Infeasible shapes — batch not divisible over ``d``, or the
    per-device memory estimate over budget — price to ``inf`` so
    ``plan_remesh`` can never pick them while a feasible shape exists.
    """
    from repro_torch.dist.compression import WIRE_BITS
    from repro_torch.models import model as MD
    from repro_torch.perf.costmodel import load_calibration
    from repro_torch.perf.costmodel.schedules import (ScheduleInputs,
                                                      strategy_comm_seconds)

    skeleton = MD.param_shapes(cfg)
    param_bytes, act_bytes = model_comm_sizes(cfg, batch, seq,
                                              skeleton=skeleton)
    opt_copies = LM_OPT_STATE_COPIES.get(optimizer, 2.0)
    cal = calibration if calibration is not None else load_calibration()
    links = cal.links()
    wire_bits = WIRE_BITS[compression]

    def predict(data: int, model: int) -> float:
        axes = {"data": int(data), "model": int(model)}
        if batch % max(axes["data"], 1) != 0:
            return float("inf")
        mem = estimate_memory(skeleton, axes, strategy,
                              opt_copies=opt_copies,
                              act_per_device_bytes=act_bytes
                              // max(axes["data"], 1))
        if mem.headroom_bytes(mem_budget_bytes) < 0:
            return float("inf")
        inp = ScheduleInputs(n_devices=axes["data"] * axes["model"],
                             param_bytes=param_bytes,
                             wire_bits=wire_bits, act_bytes=act_bytes)
        seconds = strategy_comm_seconds(strategy, inp, links, axes=axes)
        if compute_ref is not None:
            ref_s, ref_d = compute_ref
            seconds += float(ref_s) * max(int(ref_d), 1) / axes["data"]
        return seconds

    return predict
