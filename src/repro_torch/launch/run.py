"""Benchmark harness: one entry per paper table and figure, and one per
beyond-paper benchmark (``benchmarks/run.py``).

  PYTHONPATH=src python -m repro_torch.launch.run [--quick] \\
      [--only table5,...] [--rows ROWS.json] [--out results.json]

Prints CSV-ish lines ``name,key=value,...`` and the formatted tables, and
writes the JSON of every job's result to ``--out`` only. The tables fit the
LeNet rows of ``--rows`` (``launch.fit_perfmodel --rows-out``), or
``--trials`` trials measured on ``--device`` first, as the reference
measures 120 when its cache is missing. Each job maps the reference's onto
the port's entry point, in a subprocess where the reference uses one:

  table2 … fig8   ``launch.tables``         roofline  ``launch.roofline_fit``
  measured        ``launch.fit_perfmodel --sharded`` (opt in: ``--only``)
  planner         ``launch.plan --validate``
  overlap         ``launch.overlap``          elastic   ``launch.elastic``
  ft              ``launch.train``'s supervised failure drill
  trace           ``launch.trace_report``

A job that raises is reported and the harness goes on; the run then exits
non-zero. ``--quick`` takes fewer seeds and generations, and the quick form of the
planner's, the elastic and the trace benchmark (their ``--quick``). Every
job runs on ``--device``, the card unless ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

from repro_torch.launch.common import SWEEP_TRIALS, module_env


# launch.train's supervised failure drill (tools/ft_smoke.py's): reduced
# smollm in fp32 on 8 ranks, fsdp, two transient checkpoint-write faults,
# 4 ranks lost at step 4 and recovery onto tp with the survivors prebuilt
FT_DRILL = ["--arch", "smollm-360m", "--reduced", "--steps", "6", "--batch", "8",
            "--seq", "32", "--dtype", "float32", "--strategy", "fsdp",
            "--devices", "8", "--log-every", "10", "--ckpt-every", "2",
            "--inject-ckpt-fault", "2", "--max-retries", "4",
            "--simulate-failure", "4", "--fail-devices", "4",
            "--recover-strategy", "tp", "--precompile-survivors", "1",
            "--precompile-block"]


def _module(cmd) -> dict:
    """``python -m cmd...`` in a subprocess; its output's tail is printed and
    its last line returned (as JSON where it parses). Raises if it fails."""
    env = module_env()
    r = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                       env=env)
    print(r.stdout[-4000:])
    if r.returncode != 0:
        last_err = (r.stderr.strip().splitlines() or [""])[-1]
        raise RuntimeError(f"{cmd[0]} exited {r.returncode}: {last_err[-300:]}\n"
                           f"{r.stderr[-2000:]}")
    last = (r.stdout.strip().splitlines() or [""])[-1]
    try:
        return {"last_line": json.loads(last)}
    except json.JSONDecodeError:
        return {"last_line": last}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer seeds/generations (CI-scale)")
    ap.add_argument("--only", default="",
                    help="comma list: table2..table6,fig7,fig8,roofline,"
                         "measured,planner,overlap,elastic,ft,trace")
    ap.add_argument("--out", default="", help="write every job's result here")
    ap.add_argument("--rows", default="",
                    help="LeNet sweep rows JSON for the tables (else --trials "
                         "are measured)")
    ap.add_argument("--trials", type=int, default=SWEEP_TRIALS,
                    help="trials to measure when no --rows are given")
    ap.add_argument("--results-dir", default="",
                    help="the dry-run rows of the roofline job "
                         "(default: launch.dryrun's --outdir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every job (the card unless cpu)")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s]

    from repro_torch import resolve_device
    from repro_torch.launch import tables
    from repro_torch.launch.common import DRYRUN_DIR, Sweep, emit, load_rows
    from repro_torch.launch.roofline_fit import roofline_fit

    device = str(resolve_device(args.device))
    seeds = 3 if args.quick else 10
    small = 2 if args.quick else 3
    maxiter = 150 if args.quick else 300
    quick = ["--quick"] if args.quick else []
    holder = []

    def sweep() -> Sweep:
        if not holder:
            holder.append(Sweep(load_rows(args.rows, args.trials, device), device))
        return holder[0]

    def fig_mode() -> str:
        return "jit" if "jit" in sweep().modes else sweep().modes[0]

    def with_tmp(fn):
        def job():
            with tempfile.TemporaryDirectory(prefix="repro_torch_run_") as tmp:
                return fn(tmp)
        return job

    jobs = {
        "table2": lambda: tables.table2_fit(sweep(), seeds, maxiter),
        "table3": lambda: tables.table3_fit_l2(sweep(), seeds, maxiter),
        "table4": lambda: tables.table4_reg_compare(sweep(), max(seeds // 2, 2), maxiter),
        "table5": lambda: tables.table5_model_compare(sweep(), seeds, maxiter),
        "table6": lambda: tables.table6_scaling(sweep(), seeds, maxiter),
        "fig7": lambda: tables.fig7_lambda_sweep(sweep(), fig_mode(), small, maxiter),
        "fig8": lambda: tables.fig8_coeff_paths(sweep(), fig_mode(), small, maxiter),
        "roofline": lambda: roofline_fit(args.results_dir or DRYRUN_DIR, device),
        "measured": lambda: _module(
            ["repro_torch.launch.fit_perfmodel", "--sharded", "--device", device,
             "--trials", "60" if args.quick else "1500"]),
        "planner": with_tmp(lambda tmp: _module(
            ["repro_torch.launch.plan", "--validate", "--out", tmp, "--device", device,
             *quick])),
        "overlap": lambda: _module(["repro_torch.launch.overlap", "--device", device]),
        "elastic": lambda: _module(["repro_torch.launch.elastic", "--device", device,
                                    *quick]),
        "ft": with_tmp(lambda tmp: _module(
            ["repro_torch.launch.train", *FT_DRILL, "--ckpt-dir", tmp,
             "--device", device])),
        "trace": lambda: _module(["repro_torch.launch.trace_report", "--device", device,
                                  *quick]),
    }
    unknown = sorted(set(only) - set(jobs))
    if unknown:
        ap.error(f"unknown jobs {unknown}; have {', '.join(jobs)}")
    results, failed = {}, []
    for name, job in jobs.items():
        if only and name not in only:
            continue
        if not only and name == "measured":
            continue        # hours-long; opt in with --only measured
        t0 = time.time()
        try:
            results[name] = job()
            emit(f"{name}_done", seconds=f"{time.time()-t0:.1f}")
        except Exception as e:  # keep the harness running
            import traceback
            traceback.print_exc()
            emit(f"{name}_FAILED", error=str(e)[:200])
            results[name] = {"error": str(e)}
            failed.append(name)

    def default(o):
        import numpy as np
        if isinstance(o, (np.floating, np.integer)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return str(o)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=default)
        print(f"[run] wrote {args.out}")
    if failed:          # the harness ran every job; a failed one fails the run
        raise SystemExit(f"[run] jobs failed: {', '.join(failed)}")
    return results


if __name__ == "__main__":
    main()
