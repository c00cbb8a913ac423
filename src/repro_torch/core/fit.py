"""Fitting pipeline: encode → DE (torch or scipy backend) → PerfModel
(``repro.core.fit``).

Backends:
  "torch" — repro_torch.core.de (whole-population best1bin + Adam
            polish) on the device the caller names. Fast path.
  "scipy" — scipy.optimize.differential_evolution with default hyper-
            parameters, as in the paper ("we use the DE implementation
            from the scipy python package, with default values"), each
            cost evaluated by the port on ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.de import de_multi_seed
from repro_torch.core.generic_model import (FeatureSpec, PerfModel, cost_fn,
                                            encode_dataset, metrics)


@dataclass
class FitResult:
    model: PerfModel
    train_metrics: Dict[str, float]
    test_metrics: Dict[str, float]
    seed_costs: List[float]
    fit_seconds: float
    backend: str

    def summary(self) -> str:
        tm = self.test_metrics
        return (f"[{self.backend}] test MAPE {tm['mape']:.1%} "
                f"RMSE {tm['rmse']:.3g} R2 {tm['r2']:.3f} "
                f"({self.fit_seconds:.1f}s, {len(self.seed_costs)} seeds)")


def fit_model(spec: FeatureSpec, samples: Sequence[Dict],
              times: Sequence[float], *,
              test_samples: Optional[Sequence[Dict]] = None,
              test_times: Optional[Sequence[float]] = None,
              reg: str = "none", lam: float = 0.0,
              seeds: Sequence[int] = tuple(range(10)),
              backend: str = "torch", maxiter: int = 300,
              popsize: int = 15, device="cuda") -> FitResult:
    dev = resolve_device(device)
    Xnum, Xcat, Xext, t = encode_dataset(spec, samples, times, device=dev)
    bounds = spec.bounds()

    def cost(x):
        return cost_fn(spec, x, Xnum, Xcat, Xext, t, reg=reg, lam=lam)

    t0 = time.time()
    if backend == "torch":
        results = de_multi_seed(cost, bounds, seeds, maxiter=maxiter,
                                popsize=popsize, device=dev)
        xs = np.stack([r.x.cpu().numpy() for r in results])
        costs = [float(r.fun) for r in results]
    elif backend == "scipy":
        from scipy.optimize import differential_evolution

        def npf(x):
            with torch.no_grad():
                return float(cost(torch.tensor(x, dtype=torch.float32,
                                               device=dev)))

        xs, costs = [], []
        for s in seeds:
            r = differential_evolution(
                npf, list(zip(bounds[0], bounds[1])), seed=int(s),
                maxiter=maxiter)
            xs.append(r.x)
            costs.append(float(r.fun))
        xs = np.stack(xs)
    else:
        raise ValueError(backend)

    fit_s = time.time() - t0
    best = int(np.argmin(costs))
    model = PerfModel(spec, xs[best], x_seeds=xs, reg=reg, lam=lam,
                      device=str(dev))

    train_m = metrics(t.cpu().numpy(), model.predict_encoded(Xnum, Xcat, Xext))
    if test_samples is not None:
        Xn2, Xc2, Xe2, t2 = encode_dataset(spec, test_samples, test_times,
                                           device=dev)
        test_m = metrics(t2.cpu().numpy(),
                         model.predict_encoded(Xn2, Xc2, Xe2))
    else:
        test_m = dict(train_m)
    return FitResult(model, train_m, test_m, costs, fit_s, backend)


def fit_sweep_rows(spec: FeatureSpec, rows: Sequence[Dict], mode: str,
                   source: str = "simulated", *,
                   seeds: Sequence[int] = tuple(range(6)),
                   maxiter: int = 300, reg: str = "l2",
                   lam: float = 1e-3, device="cuda"
                   ) -> Tuple[FitResult, int, int]:
    """Fit the generic model against one sweep target of sweep-row dicts
    (``repro_torch.perf.sweep``). ``source`` picks the fit target per row
    ("simulated": ``measured_ms + comm_ms``; "measured": the real sharded
    column; "compute"). Returns (FitResult, n_fit, n_test).
    """
    from repro_torch.perf.sweep import split_rows
    f_s, t_s, f_t, t_t = split_rows(rows, mode, source=source)
    r = fit_model(spec, f_s, t_s, test_samples=f_t, test_times=t_t,
                  reg=reg, lam=lam, seeds=tuple(seeds), maxiter=maxiter,
                  device=device)
    return r, len(f_s), len(f_t)


def lambda_sweep(spec: FeatureSpec, samples, times, test_samples, test_times,
                 *, reg: str, lams: Sequence[float],
                 seeds=tuple(range(3)), maxiter=200,
                 device="cuda") -> List[Tuple[float, Dict]]:
    """R² / MAPE vs λ (paper Fig. 7) + coefficient paths (Fig. 8)."""
    rows = []
    for lam in lams:
        r = fit_model(spec, samples, times, test_samples=test_samples,
                      test_times=test_times, reg=reg, lam=lam, seeds=seeds,
                      maxiter=maxiter, device=device)
        rows.append((lam, {"test": r.test_metrics, "train": r.train_metrics,
                           "x": r.model.x.tolist()}))
    return rows
