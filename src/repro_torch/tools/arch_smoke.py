"""Smoke for the cross-architecture sweep: a trial a cell per family, then
a fit (``tools/arch_smoke.py``).

  PYTHONPATH=src python -m repro_torch.tools.arch_smoke [--device cuda]

For each registered non-LeNet family (lm / moe / ssm) this runs a
deterministic micro-sweep on a world of 8 ranks (``dist.pool.Pool``, gloo;
all on the card under ``cuda``): one compiled trial per cell of
``SMOKE_CELLS`` (strategy × device count × wire format) through
``perf.sweep.measure_arch_trial``, its sharded step measured on the ranks;
asserts the row schema (token norm unit, measured column populated, family
recorded), runs a tiny DE fit through the family's own FeatureSpec on
``--device``, and dry-runs ``launch.arch_sweep``'s plan, so the
cross-architecture plumbing cannot rot between full sweeps.

Exit code 0 = every family swept, fitted, and schema-valid. The last stdout
line is a JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

SMOKE_CELLS = (("dp", 2, "none"), ("fsdp", 4, "bf16"),
               ("tp", 2, "int8_ef"), ("fsdp_tp", 4, "none"))
POOL = 8


def check_row(row: dict, family: str, aspec) -> None:
    """The cross-architecture columns of a measured row."""
    from repro_torch.perf.sweep import fit_target_ms
    assert row["family"] == family, row
    assert row["norm_unit"] == aspec.norm_unit == "token", row
    assert row["t_measured_sharded"] is not None, (family, row)
    assert row["t_measured_sharded"] > 0 and row["measured_ms"] > 0
    assert row["sharded_skip"] is None, row
    assert set(aspec.spec.numeric) <= set(row["features"]), row
    assert fit_target_ms(row, "measured") > 0


def smoke_family(family: str, pool, device, maxiter: int, cells=SMOKE_CELLS) -> dict:
    """``cells``' trials of ``family`` measured and checked, then fitted."""
    import numpy as np

    from repro_torch.core.fit import fit_sweep_rows
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
    from repro_torch.perf.features import get_spec
    from repro_torch.perf.sweep import measure_arch_trial, sample_arch_point

    aspec = get_spec(family)
    rng = np.random.default_rng(7)
    rows = []
    for i, (strategy, n, comp) in enumerate(cells):
        point = dataclasses.replace(
            sample_arch_point(family, rng), strategy=strategy,
            n_devices=n, compression=comp, batch_size=8, seq_len=16)
        row = dataclasses.asdict(measure_arch_trial(
            point, "jit", n_iters=1, seed=i, sharded=True,
            calibration=DEFAULT_CALIBRATION, device=device, pool=pool))
        check_row(row, family, aspec)
        rows.append(row)
    # tiny DE fit through the family's own spec must converge
    # (duplicate the rows so the fit/test split is non-degenerate)
    r, n_fit, n_test = fit_sweep_rows(aspec.spec, rows * 3, "jit", "measured",
                                      seeds=(0,), maxiter=maxiter, device=device)
    assert np.isfinite(r.test_metrics["mape"]), r.test_metrics
    assert n_fit > 0 and n_test > 0
    return {"rows": len(rows), "fit_mape": r.test_metrics["mape"],
            "measured_ms": [row["t_measured_sharded"] for row in rows]}


def plan_runs() -> str:
    """``launch.arch_sweep --dry-run``'s output; asserts its plan line."""
    from repro_torch.launch.common import module_env
    env = module_env()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.arch_sweep",
                        "--dry-run"], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    assert "arch_sweep_plan" in r.stdout, r.stdout[-500:]
    return r.stdout


def main(argv=None, pool=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="the trials', the ranks' and the fit's device (the card "
                         "unless cpu)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool
    from repro_torch.perf.features import families

    dev = resolve_device(args.device)
    t0 = time.time()
    summary = {}
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=POOL, device=dev)) as p:
        for family in families():
            if family == "lenet":       # covered by the calibration/planner smokes
                continue
            summary[family] = smoke_family(family, p, dev, args.maxiter)
            print(f"[{family}] {summary[family]['rows']} rows, fit MAPE "
                  f"{summary[family]['fit_mape']:.1%} ({time.time()-t0:.0f}s)",
                  flush=True)
    plan_runs()
    print(json.dumps({"ok": True, "families": summary,
                      "wall_s": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
