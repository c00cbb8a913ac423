"""Calibrated collective cost model (``repro.perf.costmodel``).

  primitives  α-β ring collectives parameterized by ``LinkParams``
  schedules   per-strategy schedules composed from the primitives, bound
              to ``repro_torch.dist.sharding.STRATEGY_COLLECTIVES``
  calibrate   fits LinkParams from measured residuals (the port's DE) and
              loads the calibration JSON every simulation consumer shares
"""
from repro_torch.perf.costmodel.calibrate import (Calibration,
                                                  DEFAULT_CALIBRATION,
                                                  default_calibration_path,
                                                  fit_calibration,
                                                  load_calibration,
                                                  resimulate_rows)
from repro_torch.perf.costmodel.primitives import (COLLECTIVES, DEFAULT_LINK,
                                                   CollectiveCall, LinkParams,
                                                   collective_seconds,
                                                   schedule_seconds)
from repro_torch.perf.costmodel.schedules import (ScheduleInputs,
                                                  build_schedule,
                                                  describe_schedule,
                                                  exposed_comm_seconds,
                                                  mesh_axes_for,
                                                  strategy_comm_seconds)

__all__ = [
    "COLLECTIVES", "DEFAULT_LINK", "DEFAULT_CALIBRATION",
    "Calibration", "CollectiveCall", "LinkParams", "ScheduleInputs",
    "build_schedule", "collective_seconds", "default_calibration_path",
    "describe_schedule", "exposed_comm_seconds", "fit_calibration",
    "load_calibration", "mesh_axes_for", "resimulate_rows",
    "schedule_seconds", "strategy_comm_seconds",
]
