"""Paper tables 2–6 and figures 7–8, one function each
(``benchmarks/tables.py``).

Every function prints CSV rows via ``common.emit`` and returns the
reference's dict. Each takes the ``common.Sweep`` whose rows it fits (on
the sweep's device) and runs over the modes those rows hold, in ``MODES``
order: all three for a sweep of the three modes, as the reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch.common import Sweep, emit

LAMBDAS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)


def table2_fit(sweep: Sweep, seeds: int = 10, maxiter: int = 300) -> dict:
    """DE fit, no regularization: fitted constants per mode (Table 2)."""
    from repro_torch.core.interpret import format_table
    out = {}
    for mode in sweep.modes:
        r = sweep.fit_cached(mode, "none", 0.0, seeds, maxiter)
        rows = r.model.param_table()
        out[mode] = {"params": rows, "test": r.test_metrics}
        emit("table2", mode=mode, mape=f"{r.test_metrics['mape']:.3f}",
             r2=f"{r.test_metrics['r2']:.3f}", fit_s=f"{r.fit_seconds:.1f}")
        print(format_table(r.model, f"Table2 {mode} (no reg)"))
    return out


def table3_fit_l2(sweep: Sweep, seeds: int = 10, maxiter: int = 300,
                  lam: float = 1e-3) -> dict:
    """DE fit with L2 regularization (Table 3)."""
    from repro_torch.core.interpret import format_table
    out = {}
    for mode in sweep.modes:
        r = sweep.fit_cached(mode, "l2", lam, seeds, maxiter)
        out[mode] = {"params": r.model.param_table(),
                     "test": r.test_metrics}
        emit("table3", mode=mode, mape=f"{r.test_metrics['mape']:.3f}",
             r2=f"{r.test_metrics['r2']:.3f}")
        print(format_table(r.model, f"Table3 {mode} (L2 λ={lam})"))
    return out


def table4_reg_compare(sweep: Sweep, seeds: int = 6, maxiter: int = 250,
                       lam: float = 1e-3) -> dict:
    """L1 vs L2: MAPE / MSE / RMSE per mode (Table 4)."""
    out = {}
    for reg in ("l1", "l2"):
        for mode in sweep.modes:
            r = sweep.fit_cached(mode, reg, lam, seeds, maxiter)
            m = r.test_metrics
            out[(reg, mode)] = m
            emit("table4", reg=reg, mode=mode, mape=f"{m['mape']:.3f}",
                 mse=f"{m['mse']:.4g}", rmse=f"{m['rmse']:.4g}")
    return {f"{k[0]}/{k[1]}": v for k, v in out.items()}


def table5_model_compare(sweep: Sweep, seeds: int = 10, maxiter: int = 300) -> dict:
    """DE vs DE+reg vs RF vs SVR test MAPE (Table 5)."""
    from repro_torch.core.baselines import (SVR, RandomForestRegressor,
                                            encode_blackbox)
    from repro_torch.core.generic_model import metrics
    from repro_torch.perf.features import LENET_SPEC
    out = {}
    for mode in sweep.modes:
        f_s, t_s, f_t, t_t = sweep.split(mode)
        r_de = sweep.fit_cached(mode, "none", 0.0, seeds, maxiter)
        r_reg = sweep.fit_cached(mode, "l2", 1e-3, seeds, maxiter)
        X, Xt = encode_blackbox(LENET_SPEC, f_s), encode_blackbox(
            LENET_SPEC, f_t)
        rf = RandomForestRegressor(n_trees=60, seed=0).fit(
            X, np.asarray(t_s))
        m_rf = metrics(np.asarray(t_t), rf.predict(Xt))
        svr = SVR(iters=1200, seed=0).fit(X, np.asarray(t_s))
        m_svr = metrics(np.asarray(t_t), svr.predict(Xt))
        row = {"DE": r_de.test_metrics["mape"],
               "DE+L2": r_reg.test_metrics["mape"],
               "RF": m_rf["mape"], "SVR": m_svr["mape"]}
        out[mode] = row
        emit("table5", mode=mode,
             **{k: f"{v:.3f}" for k, v in row.items()})
    return out


def table6_scaling(sweep: Sweep, seeds: int = 10, maxiter: int = 300) -> dict:
    """Extrinsic scaling powers (Table 6): q=-1 ideal."""
    out = {}
    for mode in sweep.modes:
        r = sweep.fit_cached(mode, "none", 0.0, seeds, maxiter)
        q = r.model.scaling_powers()
        out[mode] = q
        emit("table6", mode=mode,
             q_devices=f"{q['n_devices'][0]:+.3f}±{q['n_devices'][1]:.3f}",
             q_batch=f"{q['batch_size'][0]:+.3f}±{q['batch_size'][1]:.3f}")
    return out


def fig7_lambda_sweep(sweep: Sweep, mode: str = "jit", seeds: int = 3,
                      maxiter: int = 200) -> dict:
    """R² (and MAPE) vs λ for L1 and L2 (Fig. 7)."""
    out = {}
    for reg in ("l1", "l2"):
        rows = []
        for lam in LAMBDAS:
            r = sweep.fit_cached(mode, reg, lam, seeds, maxiter)
            rows.append({"lam": lam, "r2": r.test_metrics["r2"],
                         "mape": r.test_metrics["mape"]})
            emit("fig7", reg=reg, lam=lam,
                 r2=f"{r.test_metrics['r2']:.3f}",
                 mape=f"{r.test_metrics['mape']:.3f}")
        out[reg] = rows
    return out


def fig8_coeff_paths(sweep: Sweep, mode: str = "jit", seeds: int = 3,
                     maxiter: int = 200) -> dict:
    """Coefficient paths vs λ (Fig. 8)."""
    from repro_torch.perf.features import LENET_SPEC
    names = LENET_SPEC.param_names()
    out = {}
    for lam in LAMBDAS:
        r = sweep.fit_cached(mode, "l2", lam, seeds, maxiter)
        out[lam] = dict(zip(names, [float(v) for v in r.model.x]))
        emit("fig8", lam=lam,
             a_filters=f"{out[lam]['a:n_filters']:.2f}",
             p_filters=f"{out[lam]['p:n_filters']:.2f}",
             q_dev=f"{out[lam]['q:n_devices']:.2f}",
             C=f"{out[lam]['C']:.2f}")
    return out
