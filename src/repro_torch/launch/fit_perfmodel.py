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
"""
from __future__ import annotations

import argparse
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
                    help="write the sweep rows to this JSON file")
    return ap


def _summary(xs):
    if not xs:
        return None
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "total": sum(xs)}


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.core.baselines import (RandomForestRegressor, SVR,
                                            encode_blackbox)
    from repro_torch.core.fit import fit_model
    from repro_torch.core.generic_model import metrics
    from repro_torch.core.interpret import format_table, scaling_report
    from repro_torch.launch.serve import device_name
    from repro_torch.perf.features import LENET_SPEC
    from repro_torch.perf.sweep import run_sweep, split_rows

    device = resolve_device(args.device)
    print(f"measuring {args.trials} LeNet-5 iteration times "
          f"(mode={args.mode}, device={device_name(device)})...", flush=True)
    warmup_s = []
    t0 = time.perf_counter()
    rows = run_sweep(n_trials=args.trials, modes=(args.mode,),
                     seed=args.seed, verbose_every=25, device=device,
                     warmup_s=warmup_s)
    sweep_s = time.perf_counter() - t0
    if args.rows_out:
        with open(args.rows_out, "w") as f:
            json.dump(rows, f)
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
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
