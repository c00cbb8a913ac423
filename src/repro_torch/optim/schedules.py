"""Learning-rate schedules (``repro.optim.schedules``).

Computed on the host in float32, as the reference computes them, and
returned as a Python float: the step count is a host integer in the port,
so the schedule needs nothing from the device.
"""
from __future__ import annotations

import numpy as np


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    f32 = np.float32
    step = f32(step)
    warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
    t = (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
    t = np.clip(t, f32(0.0), f32(1.0))
    cos = f32(peak_lr) * (f32(final_frac) + f32(1 - final_frac) * f32(0.5)
                          * (f32(1) + np.cos(f32(np.pi) * t)))
    return float(warm if step < warmup_steps else cos)
