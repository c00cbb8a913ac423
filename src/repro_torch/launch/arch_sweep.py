"""Cross-architecture measured sweep (``benchmarks/arch_sweep.py``): LM,
MoE and SSM through one generic model, on a CUDA device unless ``--device
cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.arch_sweep --out DIR          # all families
  PYTHONPATH=src python -m repro_torch.launch.arch_sweep --out DIR --quick  # 8 trials a family
  PYTHONPATH=src python -m repro_torch.launch.arch_sweep --out DIR \
      --rows-dir benchmarks/artifacts                                       # re-fit only

The genericity check of the paper's title: the same expression fitted per
architecture family (transformer LM ``reduced(smollm-360m)``, MoE
``reduced(llama4-scout)``, SSM ``reduced(mamba2-370m)``), with the compiled
LM train step as the measured subject: each trial's compute probe is the
compiled single-device step on the per-device sub-batch, its sharded probe
the compiled overlap body over ``n_devices`` ranks of a world of ``--pool``
ranks (``dist.pool.Pool``, gloo; under ``cuda`` all ranks share the card).
The trials time mode "jit" (``MODE``, the reference's ``run_arch_sweep``
default): ``torch.compile(fullgraph=True)`` of the step that returns a new
state (``train.step``); a point that does not compile in one graph is an
error row carrying dynamo's reason, never a row timed eagerly.

Per family it runs sweep → link calibration → DE fit (measured and
calibrated-simulated targets), then prices every family's residuals under
every other family's fitted link: the transfer matrix that says whether a
calibrated link is a property of the interconnect or leaks workload shape.

Writes into ``--out`` (required unless ``--dry-run``; never a directory
under ``benchmarks/``): ``arch_sweep_{family}.json`` (the rows, when
measured), ``arch_sweep_fit.json`` (fits, calibrations, transfer matrix)
and ``ARCH_SWEEP.md`` (the report, which is also printed). The last stdout
line is a JSON summary: the plan, seconds, rows per family and the
transfer matrix.
"""
from __future__ import annotations

import argparse
import json
import os
import time

ARCH_FAMILIES = ("lm", "moe", "ssm")
N_POOL = 8                  # the reference's host pool (``DEFAULT_POOL``)
MODE = "jit"                # the compiled step the trials time
_BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "benchmarks")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=",".join(ARCH_FAMILIES),
                    help="comma-separated subset of lm,moe,ssm")
    ap.add_argument("--trials", type=int, default=None,
                    help="trials per family (48; --quick: 8)")
    ap.add_argument("--quick", action="store_true",
                    help="8 trials/family (unless --trials), 2 seeds, "
                         "maxiter 120")
    ap.add_argument("--rows-dir", default="",
                    help="directory with existing arch_sweep_{family}.json "
                         "rows: skip measuring, re-fit from them")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=250)
    ap.add_argument("--overlap", action="store_true", default=True,
                    help="jointly fit a per-strategy overlap factor rho "
                         "per family (default on)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="serialized-schedule fits only")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan and exit without measuring")
    ap.add_argument("--device", default="cuda",
                    help="torch device to sweep and fit on")
    ap.add_argument("--pool", type=int, default=N_POOL,
                    help="ranks of the world the sharded probes run on")
    ap.add_argument("--out", default="",
                    help="directory to write the rows, fits and report into")
    return ap


def _fmt_powers(model) -> str:
    return ", ".join(f"{k}={mean:+.2f}±{std:.2f}"
                     for k, (mean, std) in model.scaling_powers().items())


def _transfer_md(matrix, families):
    evals = [f for f in families if any(f in row for row in matrix.values())]
    lines = ["| link fitted on \\ priced on | " +
             " | ".join(evals) + " |",
             "|---|" + "|".join("---" for _ in evals) + "|"]
    for fit_f in list(families) + ["default"]:
        row = matrix.get(fit_f)
        if not row:
            continue
        cells = [f"{row[e]:.2f}" if e in row else "—" for e in evals]
        name = "uncalibrated default" if fit_f == "default" else fit_f
        lines.append(f"| {name} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def report_md(args, device_label: str, rows_by_family, fits, cals,
              matrix) -> str:
    """The reference's report sections (``benchmarks/arch_sweep.py``): the
    families and their rows, each fit's test MAPE and powers, the transfer
    matrix and each family's fitted link."""
    from repro_torch.perf.features import get_spec

    source = (f"re-fitted from the rows in `{args.rows_dir}`" if args.rows_dir
              else f"measured by `python -m repro_torch.launch.arch_sweep "
                   f"--trials {args.trials}` on {device_label}, sharded "
                   f"probes over a pool of {args.pool} ranks")
    lines = [
        "# Cross-architecture sweep: one generic model, three families",
        "",
        f"Rows {source}. Subject: the compiled LM train step "
        f"(`make_train_step` / `make_sharded_train_step(overlap=True)`, "
        f"mode {MODE}); fit targets are token-normalized "
        f"(`REF_TOKENS` per `norm_unit`).",
        "",
        "| family | arch | numeric intrinsics | rows (measured) |",
        "|---|---|---|---|",
    ]
    for f, rows in rows_by_family.items():
        aspec = get_spec(f)
        ok = [r for r in rows if "error" not in r]
        n_meas = sum(1 for r in ok
                     if r.get("t_measured_sharded") is not None)
        lines.append(f"| {f} | `{aspec.arch_id}` | "
                     f"{', '.join(aspec.spec.numeric)} | "
                     f"{len(ok)} ({n_meas}) |")
    lines.append("")
    for (family, source), (r, n_fit, n_test) in fits.items():
        tm = r.test_metrics
        lines += [
            f"## {family} — fit target: {source} "
            f"({n_fit} fit / {n_test} test)", "",
            f"test MAPE {tm['mape']:.1%}, R² {tm['r2']:.3f}; fitted "
            f"powers: {_fmt_powers(r.model)}", ""]
    lines += [
        "## Link-parameter transfer across families", "",
        "Residual MAE (ms) of each family's fitted link priced on every "
        "family's measured−compute residuals (diagonal = own fit; "
        "`uncalibrated default` = the documented α-β constants, the "
        "no-fit baseline):", "",
        _transfer_md(matrix, list(rows_by_family)), ""]
    for f, cal in cals.items():
        m = cal.meta
        rho = ("" if not cal.overlap else "; ρ " + ", ".join(
            f"{s}={r:.2f}" for s, r in sorted(cal.overlap.items())))
        lines.append(f"* `{cal.label}`: α {cal.default.alpha_s*1e6:.2f} µs, "
                     f"bw {cal.default.bw_bytes_per_s/1e9:.3f} GB/s over "
                     f"{m.get('n_rows')} rows (MAE "
                     f"{m.get('mae_ms_default'):.2f} ms default → "
                     f"{m.get('mae_ms_fitted'):.2f} ms fitted{rho})")
    lines.append("")
    return "\n".join(lines)


def _out_dir(ap, args) -> str:
    if not args.out:
        ap.error("--out DIR is required: the directory the rows, fits and "
                 "report are written into")
    out = os.path.abspath(args.out)
    if os.path.commonpath([out, _BENCHMARKS]) == _BENCHMARKS:
        ap.error(f"--out {args.out} lies under benchmarks/, which holds the "
                 "reference's checked-in results")
    return out


def main(argv=None, pool=None):
    """Run the sweep and fits; ``pool``, when given, is the open ``Pool``
    the sharded probes run on (else one of ``--pool`` ranks is opened)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.quick:
        args.seeds, args.maxiter = 2, 120
    if args.trials is None:
        args.trials = 8 if args.quick else 48
    families = tuple(f for f in args.families.split(",") if f)
    unknown = set(families) - set(ARCH_FAMILIES)
    if unknown:
        ap.error(f"unknown families {sorted(unknown)}; have {ARCH_FAMILIES}")
    plan = {"families": list(families), "trials": args.trials,
            "devices": args.pool, "seeds": args.seeds,
            "maxiter": args.maxiter, "rows_dir": args.rows_dir or None,
            "overlap": bool(args.overlap), "device": args.device,
            "mode": MODE}
    print(json.dumps({"arch_sweep_plan": plan}), flush=True)
    if args.dry_run:
        return plan
    out = _out_dir(ap, args)

    import contextlib

    from repro_torch import resolve_device
    from repro_torch.core.fit import fit_sweep_rows
    from repro_torch.launch.serve import device_name
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION, resimulate_rows
    from repro_torch.perf.costmodel.calibrate import (fit_family_calibrations,
                                                      link_transfer_matrix)
    from repro_torch.perf.features import get_spec
    from repro_torch.perf.sweep import run_arch_sweep

    device = resolve_device(args.device)
    os.makedirs(out, exist_ok=True)
    rows_by_family = {}
    t0 = time.time()
    if args.rows_dir:
        for family in families:
            with open(os.path.join(args.rows_dir,
                                   f"arch_sweep_{family}.json")) as f:
                rows_by_family[family] = json.load(f)
            print(f"[{family}] loaded {len(rows_by_family[family])} rows",
                  flush=True)
    else:
        from repro_torch.dist.pool import Pool
        with (contextlib.nullcontext(pool) if pool is not None
              else Pool(world=args.pool, device=device)) as world:
            for family in families:
                path = os.path.join(out, f"arch_sweep_{family}.json")
                # priced under the default link, so the rows are
                # reproducible without a pre-existing calibration
                rows_by_family[family] = run_arch_sweep(
                    family, n_trials=args.trials, mode=MODE,
                    out_path=path, calibration=DEFAULT_CALIBRATION,
                    device=device, pool=world)
                print(f"[{family}] sweep done ({time.time()-t0:.0f}s) -> "
                      f"{path}", flush=True)
    sweep_s = time.time() - t0

    # -- per-family link calibration + the transfer matrix ---------------
    t1 = time.time()
    cals = fit_family_calibrations(rows_by_family, overlap=args.overlap,
                                   seeds=tuple(range(args.seeds)),
                                   maxiter=args.maxiter, source="arch_sweep",
                                   device=device)
    matrix = link_transfer_matrix(rows_by_family, cals)
    print(json.dumps({"link_transfer_mae_ms": matrix}, indent=1), flush=True)

    # -- the generic model, fitted per family ----------------------------
    fits = {}
    for family, rows in rows_by_family.items():
        spec = get_spec(family).spec
        targets = [("measured", rows)]
        if family in cals:
            targets.append(("simulated (calibrated)",
                            resimulate_rows(rows, cals[family])))
        for source, fit_rows in targets:
            r, n_fit, n_test = fit_sweep_rows(
                spec, fit_rows, MODE,
                "measured" if source == "measured" else "simulated",
                seeds=tuple(range(args.seeds)), maxiter=args.maxiter,
                device=device)
            fits[(family, source)] = (r, n_fit, n_test)
            print(f"[{family}/{source}] {r.summary()}", flush=True)
    fit_s = time.time() - t1

    fit_blob = {}
    for (family, source), (r, n_fit, n_test) in fits.items():
        fit_blob[f"{family}:{source}"] = {
            "test": r.test_metrics, "train": r.train_metrics,
            "n_fit": n_fit, "n_test": n_test,
            "scaling_powers": r.model.scaling_powers(),
            "params": r.model.param_table(),
            "x": [float(v) for v in r.model.x],
            "seed_costs": list(r.seed_costs)}
    blob = {"plan": plan, "fits": fit_blob,
            "calibrations": {f: c.to_dict() for f, c in cals.items()},
            "link_transfer_mae_ms": matrix}
    with open(os.path.join(out, "arch_sweep_fit.json"), "w") as f:
        json.dump(blob, f, indent=1, default=float)
    md = report_md(args, device_name(device), rows_by_family, fits, cals,
                   matrix)
    with open(os.path.join(out, "ARCH_SWEEP.md"), "w") as f:
        f.write(md)
    print(md, flush=True)
    summary = {"plan": plan, "device": device_name(device),
               "sweep_s": sweep_s, "fit_s": fit_s,
               "rows": {f: {"ok": sum("error" not in r for r in rows),
                            "error": sum("error" in r for r in rows)}
                        for f, rows in rows_by_family.items()},
               "link_transfer_mae_ms": matrix}
    print(json.dumps(summary), flush=True)
    return blob


if __name__ == "__main__":
    main()
