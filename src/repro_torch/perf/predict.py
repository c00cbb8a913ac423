"""The single feature→time prediction path (``repro.perf.predict``):

  * ``predict_samples`` — vectorized fitted-model prediction for a list
    of feature dicts, with an optional symmetric relative uncertainty
    band (the caller supplies the band width, typically the fit's
    held-out MAPE — the paper's own error statistic);
  * ``estimate_comm`` — one strategy's per-iteration collective cost
    under the shared calibration (``load_calibration`` resolution
    rules), as a structured ``CommEstimate`` whose ``calibrated`` flag
    lets consumers say out loud when uncalibrated α-β defaults priced
    the schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.generic_model import PerfModel
from repro_torch.perf.costmodel import (Calibration, ScheduleInputs,
                                        describe_schedule, load_calibration,
                                        mesh_axes_for, strategy_comm_seconds)


def predict_samples(model: PerfModel, samples: Sequence[Dict],
                    rel_band: float = 0.0
                    ) -> Union[np.ndarray,
                               Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Vectorized fitted-model prediction for raw feature dicts.

    With ``rel_band == 0`` returns the predicted times ``[N]``; with a
    positive band (e.g. the fit's held-out MAPE) returns
    ``(mean, lo, hi)`` where ``lo/hi = mean ∓ rel_band·|mean|`` — the
    uncertainty the fit residuals justify, clamped at zero below.
    """
    mean = np.asarray(model.predict(list(samples)), float)
    if rel_band <= 0.0:
        return mean
    spread = rel_band * np.abs(mean)
    lo = np.maximum(mean - spread, 0.0)
    return mean, lo, mean + spread


@dataclass(frozen=True)
class CommEstimate:
    """One strategy's schedule-priced collective cost, with provenance.

    ``seconds`` is the full serialized schedule price; ``exposed_seconds``
    subtracts what the overlap train step hides behind compute
    (``max(0, comm − ρ·compute)`` with the calibration's fitted ρ) — it
    equals ``seconds`` when no overlap factor or compute time is known.
    """
    strategy: str
    n_devices: int
    mesh_axes: Dict[str, int]
    param_bytes: int
    act_bytes: int
    wire_bits: int
    seconds: float
    calibration_label: str
    schedule: Optional[Tuple[Dict, ...]] = None   # per-call breakdown
    overlap: float = 0.0                          # fitted ρ for the strategy
    exposed_seconds: Optional[float] = None

    @property
    def exposed(self) -> float:
        return (self.seconds if self.exposed_seconds is None
                else self.exposed_seconds)

    @property
    def calibrated(self) -> bool:
        """False when the documented α-β defaults priced this estimate —
        consumers (planner reports, --report-comm) surface that loudly
        so an uncalibrated number is never mistaken for a fitted one."""
        return self.calibration_label != "default"

    def to_dict(self) -> Dict:
        out = {"strategy": self.strategy, "n_devices": self.n_devices,
               "mesh_axes": dict(self.mesh_axes),
               "param_bytes": self.param_bytes,
               "act_bytes": self.act_bytes, "wire_bits": self.wire_bits,
               "per_step_ms": self.seconds * 1e3,
               "overlap": self.overlap,
               "exposed_ms": self.exposed * 1e3,
               "calibration": self.calibration_label,
               "calibrated": self.calibrated}
        if self.schedule is not None:
            out["schedule"] = [dict(c) for c in self.schedule]
        return out


def estimate_comm(strategy: str, n_devices: int, param_bytes: int, *,
                  wire_bits: int = 32, act_bytes: int = 0,
                  compute_seconds: float = 0.0,
                  calibration: Optional[Calibration] = None,
                  detail: bool = False) -> CommEstimate:
    """Price one training iteration's collectives for ``strategy``.

    ``calibration=None`` resolves the shared calibration via
    ``load_calibration`` (checked-in artifact when present, documented
    defaults otherwise). ``detail=True`` additionally attaches the
    per-collective breakdown (``describe_schedule``). When the caller
    knows the iteration's compute time, ``compute_seconds`` prices the
    overlap: ``exposed_seconds = max(0, comm − ρ·compute)`` with the
    calibration's fitted per-strategy ρ.
    """
    cal = calibration if calibration is not None else load_calibration()
    links = cal.links()
    inp = ScheduleInputs(n_devices=n_devices, param_bytes=param_bytes,
                         wire_bits=wire_bits, act_bytes=act_bytes)
    sched = (tuple(describe_schedule(strategy, inp, links))
             if detail else None)
    seconds = strategy_comm_seconds(strategy, inp, links)
    rho = cal.overlap_for(strategy)
    exposed = max(0.0, seconds - rho * float(compute_seconds))
    return CommEstimate(
        strategy=strategy, n_devices=n_devices,
        mesh_axes=mesh_axes_for(strategy, n_devices),
        param_bytes=param_bytes, act_bytes=act_bytes, wire_bits=wire_bits,
        seconds=seconds, calibration_label=cal.label, schedule=sched,
        overlap=rho, exposed_seconds=exposed)
