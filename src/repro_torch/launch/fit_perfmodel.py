"""The paper's pipeline end to end on *measured* data
(``examples/fit_perfmodel.py``): sweep LeNet-5 iteration times over the
Table-1 space on a CUDA device (unless ``--device cpu`` is given), fit the
generic model there by differential evolution with L2 regularization,
compare it against the black-box baselines, and print the paper-style
tables.

  PYTHONPATH=src python -m repro_torch.launch.fit_perfmodel --trials 90

The last stdout line is a JSON report: the device's name, the rows per
mode (ok / error), the sweep's seconds and its warm-up iterations'
seconds (the compile, in a compiled mode), the fit's seconds, the best
seed's cost, and the test MAPE of the generic model, the random forest
and the ε-SVR. ``--rows-out`` writes the sweep rows as JSON. The fit is
underdetermined below ~60 trials (the LeNet spec has 30 constants), so do
not read MAPE at tiny trial counts.

``--sharded`` is the measured-vs-simulated pipeline
(``benchmarks/measured_sweep.py``): every compiled trial also measures the
real sharded iteration over ``n_devices`` ranks of a world of ``--pool``
ranks (``dist.pool.Pool``, gloo; under ``cuda`` all ranks share the card),
the sweep is priced under the default link, the link is calibrated from
the measured residuals (written only to ``--calibration-out``, when given),
and the generic model is fitted against the measured target and against
the simulated one under the default and the calibrated link. The report
gains the pool, the measured rows' count, the residual MAE before and
after calibration and the three fits' test MAPE and scaling powers.

  PYTHONPATH=src python -m repro_torch.launch.fit_perfmodel --sharded \
      --device cpu --pool 4 --trials 8
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=90)
    ap.add_argument("--mode", default="jit",
                    choices=["jit", "jit_donate", "eager"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to sweep and fit on")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the sampled configs and their weights")
    ap.add_argument("--rows-out", default="",
                    help="write the sweep rows to this JSON file (every 25 "
                         "trials and at the end)")
    ap.add_argument("--sharded", action="store_true",
                    help="measure each compiled trial's sharded iteration on "
                         "a pool of ranks, calibrate the link and fit the "
                         "measured and simulated targets")
    ap.add_argument("--pool", type=int, default=8,
                    help="ranks of the --sharded world")
    ap.add_argument("--calibration-out", default="",
                    help="write the fitted link calibration to this file")
    return ap


def _summary(xs):
    if not xs:
        return None
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "total": sum(xs)}


def main(argv=None, pool=None):
    """Run the pipeline; ``pool``, when given, is the open ``Pool`` that
    ``--sharded`` measures on (else it opens one of ``--pool`` ranks)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sharded and args.mode == "eager":
        ap.error("--sharded measures compiled iterations: use --mode jit or "
                 "jit_donate")

    from repro_torch import resolve_device
    from repro_torch.core.baselines import (RandomForestRegressor, SVR,
                                            encode_blackbox)
    from repro_torch.core.fit import fit_model
    from repro_torch.core.generic_model import metrics
    from repro_torch.core.interpret import format_table, scaling_report
    from repro_torch.launch.serve import device_name
    from repro_torch.perf.features import LENET_SPEC
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
    from repro_torch.perf.sweep import run_sweep, split_rows

    device = resolve_device(args.device)
    print(f"measuring {args.trials} LeNet-5 iteration times "
          f"(mode={args.mode}, device={device_name(device)}"
          f"{f', sharded over a pool of {args.pool}' if args.sharded else ''})"
          "...", flush=True)
    warmup_s = []
    t0 = time.perf_counter()
    sweep = dict(n_trials=args.trials, modes=(args.mode,), seed=args.seed,
                 verbose_every=25, device=device, warmup_s=warmup_s,
                 out_path=args.rows_out or None)
    if args.sharded:
        from repro_torch.dist.pool import Pool
        # priced under the default link, so the rows do not depend on a
        # calibration written before
        with (contextlib.nullcontext(pool) if pool is not None
              else Pool(world=args.pool, device=device)) as pool:
            rows = run_sweep(**sweep, sharded=True, pool=pool,
                             calibration=DEFAULT_CALIBRATION)
    else:
        rows = run_sweep(**sweep)
    sweep_s = time.perf_counter() - t0
    f_s, t_s, f_t, t_t = split_rows(rows, args.mode)
    print(f"fit {len(f_s)} / test {len(f_t)} samples", flush=True)

    r = fit_model(LENET_SPEC, f_s, t_s, test_samples=f_t, test_times=t_t,
                  reg="l2", lam=1e-3, seeds=range(5), maxiter=300,
                  device=device)
    print(r.summary())
    print(format_table(r.model, "LeNet-5 generic model (L2)"))
    print(scaling_report(r.model))

    X, Xt = encode_blackbox(LENET_SPEC, f_s), encode_blackbox(LENET_SPEC,
                                                              f_t)
    rf = RandomForestRegressor(n_trees=50).fit(X, np.asarray(t_s))
    svr = SVR(iters=800).fit(X, np.asarray(t_s))
    mape = {"generic": r.test_metrics["mape"],
            "random_forest": metrics(np.asarray(t_t), rf.predict(Xt))["mape"],
            "svr": metrics(np.asarray(t_t), svr.predict(Xt))["mape"]}
    print("\n== black-box comparison (test MAPE) ==")
    print(f"  generic model : {mape['generic']:.1%}")
    print(f"  random forest : {mape['random_forest']:.1%}"
          "   (no interpretability)")
    print(f"  ε-SVR         : {mape['svr']:.1%}")

    n_err = sum("error" in row for row in rows)
    report = {"device": device_name(device), "mode": args.mode,
              "trials": args.trials, "seed": args.seed,
              "rows": {args.mode: {"ok": len(rows) - n_err, "error": n_err}},
              "sweep_s": sweep_s, "warmup_s": _summary(warmup_s),
              "n_fit": len(f_s), "n_test": len(f_t),
              "fit_s": r.fit_seconds, "best_cost": min(r.seed_costs),
              "test_mape": mape}
    if args.sharded:
        report.update(_sharded_fits(args, rows, device, pool_ranks=pool.world))
    print(json.dumps(report), flush=True)
    return report


def _sharded_fits(args, rows, device, pool_ranks: int):
    """``benchmarks/measured_sweep.py``'s analysis of the sharded rows: the
    link calibrated from the measured residuals, then the generic model
    fitted against the measured target and the simulated one under the
    default and the calibrated link; prints the before/after and
    measured-vs-simulated tables and returns the report's entries."""
    from repro_torch.core.fit import fit_sweep_rows
    from repro_torch.core.interpret import calibration_report, residual_report
    from repro_torch.perf.costmodel import (DEFAULT_CALIBRATION,
                                            fit_calibration, resimulate_rows)
    from repro_torch.perf.features import LENET_SPEC

    seeds = tuple(range(5))
    cal = fit_calibration(rows, per_collective=True, overlap=True,
                          seeds=seeds, maxiter=300, source="fit_perfmodel",
                          device=device)
    if args.calibration_out:
        cal.save(args.calibration_out)
    print(f"calibrated {cal.label}: MAE {cal.meta['mae_ms_default']:.3f} ms "
          f"(default) -> {cal.meta['mae_ms_fitted']:.3f} ms", flush=True)
    rows_default = resimulate_rows(rows, DEFAULT_CALIBRATION)
    rows_cal = resimulate_rows(rows, cal)
    fits = {}
    for source, fit_rows in (("measured", rows),
                             ("simulated (default link)", rows_default),
                             ("simulated (calibrated)", rows_cal)):
        r, n_fit, n_test = fit_sweep_rows(
            LENET_SPEC, fit_rows, args.mode,
            "measured" if source == "measured" else "simulated",
            seeds=seeds, maxiter=300, device=device)
        print(f"[{source}] {r.summary()}", flush=True)
        q = r.model.scaling_powers()
        fits[source] = {"n_fit": n_fit, "n_test": n_test,
                        "test_mape": r.test_metrics["mape"],
                        "q_gpus": q["n_devices"], "q_wire_bits": q["wire_bits"]}
    print(calibration_report(rows, cal, rows_default=rows_default,
                             rows_calibrated=rows_cal), flush=True)
    print(residual_report(rows_cal), flush=True)
    measured = [r for r in rows if "error" not in r
                and r.get("t_measured_sharded") is not None]
    return {"pool": {"ranks": pool_ranks, "backend": "gloo",
                     "cards": 1 if device.type == "cuda" else 0},
            "measured_rows": len(measured),
            "residual_mae_ms": {"default": cal.meta["mae_ms_default"],
                                "calibrated": cal.meta["mae_ms_fitted"]},
            "calibration": cal.to_dict(),
            "sharded_fits": fits}


if __name__ == "__main__":
    main()
