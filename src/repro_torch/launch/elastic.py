"""Elastic-recovery drill: the measured cost of a failure and its resume
(the counterpart of ``benchmarks/elastic.py``).

  PYTHONPATH=src python -m repro_torch.launch.elastic --out ELASTIC.md
  PYTHONPATH=src python -m repro_torch.launch.elastic --quick --device cpu

Runs ``launch.train``'s ``--simulate-failure`` drill over a pool of 8 ranks
(the reference's tiny fp32 smollm-360m, 6 steps, a checkpoint every 3, 4 of
8 ranks lost at step 3, ``--recover-strategy auto``) for each starting
strategy of the registry, twice:

* **cold**: the recovery plans, builds the survivor mesh's program and
  restores;
* **prebuilt**: ``--precompile-survivors 1 --precompile-block``: the plan,
  mesh, specs and state skeleton were built in the background while healthy
  steps ran (``train.supervisor``), so the recovery skips that work. The
  port's step is eager: there is no compile for the first step to pay, so
  the reference's cold/warm first-step gate (a re-jit it hides) has nothing
  to measure here and is reported, not gated.

Each drill is scored against its own uninterrupted run: the losses must
match within ``256 * np.spacing(np.float32(8.0))``. The measured restart
costs then feed the planner's elastic-aware objective
(``perf.planner.RestartCosts``): the LeNet launch space ranked by expected
wall clock at failure rate λ, and where the steady-state pick flips.
``--quick`` drills one strategy (fsdp). The markdown report is written only
to ``--out``; the last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import tempfile
import time

import numpy as np

STEPS, FAIL, LOST, POOL = 6, 3, 4, 8
TOL = float(256 * np.spacing(np.float32(8.0)))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="write the markdown report here")
    ap.add_argument("--quick", action="store_true", help="one strategy: fsdp")
    ap.add_argument("--device", default="cuda")
    return ap


def base_args(strategy: str, device: str):
    return ["--arch", "smollm-360m", "--reduced", "--steps", str(STEPS),
            "--batch", "8", "--seq", "32", "--dtype", "float32",
            "--strategy", strategy, "--ckpt-every", str(FAIL),
            "--log-every", "100", "--devices", str(POOL), "--device", device]


def _train(argv, pool):
    from repro_torch.launch.train import main as train_main
    with contextlib.redirect_stdout(io.StringIO()):
        return train_main(argv, pool=pool)


def run_drill(strategy: str, ref, precompile: bool, pool, device: str):
    extra = ["--precompile-survivors", "1", "--precompile-block"] if precompile else []
    ckpt_dir = tempfile.mkdtemp(prefix=f"elastic_{strategy}_")
    try:
        drill = _train(base_args(strategy, device) + [
            "--ckpt-dir", ckpt_dir, "--simulate-failure", str(FAIL),
            "--fail-devices", str(LOST), "--recover-strategy", "auto"] + extra, pool)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = drill["recovery"]
    errs = [abs(a - b) for a, b in zip(drill["losses"], ref["losses"])]
    return {"initial": strategy, "recovered": rec["after"]["strategy"],
            "mesh_before": rec["before"]["mesh"], "mesh_after": rec["after"]["mesh"],
            "steps_replayed": rec["steps_replayed"],
            "precompiled": bool(rec["precompiled"]),
            "restore_mode": rec["restore_mode"],
            "plan_ms": rec["plan_s"] * 1e3, "compile_ms": rec["compile_s"] * 1e3,
            "restore_ms": rec["restore_s"] * 1e3,
            "first_step_ms": rec["first_step_s"] * 1e3,
            "recovery_ms": rec["recovery_s"] * 1e3,
            "max_loss_err": max(errs),
            "parity": len(drill["losses"]) == len(ref["losses"]) and max(errs) <= TOL}


def run_pair(strategy: str, pool, device: str):
    ref = _train(base_args(strategy, device), pool)
    cold = run_drill(strategy, ref, False, pool, device)
    warm = run_drill(strategy, ref, True, pool, device)
    if not (warm["precompiled"] and not cold["precompiled"]):
        raise SystemExit(f"{strategy}: the prebuilt drill did not use its build: "
                         f"{cold}, {warm}")
    return {"strategy": strategy, "cold": cold, "warm": warm,
            "speedup": cold["recovery_ms"] / max(warm["recovery_ms"], 1e-9)}


def _mean(rows, variant, key):
    return float(np.mean([r[variant][key] for r in rows]))


def measured_restart_costs(rows):
    """(cold, prebuilt) ``RestartCosts`` from the drills' means; the compile
    term is the measured first post-recovery step plus the exposed wait
    for the build, ``replay_steps`` the expected steps lost under uniform
    failure arrival (checkpoint_every / 2)."""
    from repro_torch.perf.planner import RestartCosts

    def mk(variant):
        return RestartCosts(plan_ms=_mean(rows, variant, "plan_ms"),
                            compile_ms=_mean(rows, variant, "first_step_ms")
                            + _mean(rows, variant, "compile_ms"),
                            restore_ms=_mean(rows, variant, "restore_ms"),
                            replay_steps=FAIL / 2.0)
    return mk("cold"), mk("warm")


def strategy_device_flip(preds, costs, lams):
    """The first λ where the top pick's (strategy, n_devices) changes from
    the steady-state pick, or None."""
    from repro_torch.perf.planner import rank_elastic
    base = rank_elastic(preds, costs, 0.0)[0]
    cell = (base.point.strategy, base.point.n_devices)
    for lam in lams:
        top = rank_elastic(preds, costs, lam)[0]
        if (top.point.strategy, top.point.n_devices) != cell:
            return float(lam), base, top
    return None


def elastic_planner_section(rows, device: str):
    from repro_torch.configs.lenet5 import LeNet5Config
    from repro_torch.perf.planner import (PlannerModel, enumerate_lenet_space,
                                          predict_points, render_elastic_table)
    cold, warm = measured_restart_costs(rows)
    model = PlannerModel.load(device=device)
    feasible, _ = enumerate_lenet_space(LeNet5Config(), pool=POOL)
    preds = predict_points(model, feasible)
    scan = np.geomspace(1e-2, 1e6, 161)
    flip_cold = strategy_device_flip(preds, cold, scan)
    flip_warm = strategy_device_flip(preds, warm, scan)
    anchor = flip_cold[0] if flip_cold is not None else 1e3
    lams = sorted({0.0, round(anchor / 10.0, 2), round(anchor, 2),
                   round(anchor * 10.0, 2)})
    return {"costs_cold": cold.to_dict(), "costs_warm": warm.to_dict(),
            "n_feasible": len(preds), "flip_cold": flip_cold, "flip_warm": flip_warm,
            "lams": lams, "table_cold": render_elastic_table(preds, cold, lams),
            "table_warm": render_elastic_table(preds, warm, lams)}


def _fmt_flip(flip):
    if flip is None:
        return "no flip in the scanned range (λ ≤ 1e6)"
    lam, base, top = flip
    return (f"λ ≈ {lam:.3g}: {base.point.strategy} @ {base.point.n_devices} dev → "
            f"{top.point.strategy} @ {top.point.n_devices} dev")


def render_md(rows, elastic, card: str, wall_s: float) -> str:
    lines = [
        "# Elastic recovery drill: measured failure → resume cost", "",
        f"`python -m repro_torch.launch.elastic` on {card}, a pool of {POOL} ranks "
        f"(tiny fp32 smollm-360m, {STEPS} steps, failure at step {FAIL}, {LOST} of "
        f"{POOL} ranks lost). Parity: the losses against an uninterrupted run within "
        f"{TOL:.1e}.", "",
        "| initial | recovered | mesh | restore mode | plan ms | restore ms | first "
        "step ms (cold) | first step ms (prebuilt) | recovery ms (cold) | recovery "
        "ms (prebuilt) | parity |",
        "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        c, w = r["cold"], r["warm"]
        mesh = f"{tuple(c['mesh_before'])} → {tuple(c['mesh_after'])}"
        parity = "OK" if (c["parity"] and w["parity"]) else "FAIL"
        lines.append(
            f"| {c['initial']} | {c['recovered']} | {mesh} | {w['restore_mode']} | "
            f"{c['plan_ms']:.1f} | {c['restore_ms']:.1f} | {c['first_step_ms']:.1f} | "
            f"{w['first_step_ms']:.1f} | {c['recovery_ms']:.1f} | "
            f"{w['recovery_ms']:.1f} | {parity} |")
    lines += [
        "", "## Elastic-aware planning: expected wall clock at failure rate λ", "",
        f"The measured restart terms feed `perf.planner.RestartCosts`; the planner "
        f"ranks the {elastic['n_feasible']}-point LeNet launch space by "
        "`E[T] = T·(1 + λ·n_devices·restart_ms/3.6e6)`.", "",
        f"Measured restart costs (ms): cold {json.dumps(elastic['costs_cold'])}, "
        f"prebuilt {json.dumps(elastic['costs_warm'])}.", "",
        "### Cold", "", *elastic["table_cold"], "",
        f"(strategy, devices) pick flip: {_fmt_flip(elastic['flip_cold'])}.", "",
        "### Prebuilt", "", *elastic["table_warm"], "",
        f"(strategy, devices) pick flip: {_fmt_flip(elastic['flip_warm'])}.", "",
        f"Total drill wall time: {wall_s:.1f} s.", ""]
    return "\n".join(lines)


def main(argv=None, pool=None):
    """Run the drills; returns the rows. ``pool``, when given, is an open
    ``Pool`` of (at least) 8 ranks."""
    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool
    from repro_torch.dist.sharding import STRATEGIES
    from repro_torch.launch.serve import device_name

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    strategies = ("fsdp",) if args.quick else tuple(sorted(STRATEGIES))
    t0 = time.time()
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=POOL, device=device)) as pool:
        rows = [run_pair(s, pool, str(device)) for s in strategies]
    wall = time.time() - t0
    failures = [r["strategy"] for r in rows
                if not (r["cold"]["parity"] and r["warm"]["parity"])]
    if failures:
        raise SystemExit(f"parity failed for {failures}: {rows}")
    elastic = elastic_planner_section(rows, str(device))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(render_md(rows, elastic, device_name(device), wall))
        print(f"wrote {args.out}")
    print(json.dumps({
        "ok": True, "drills": 2 * len(rows),
        "rows": rows,
        "costs_cold": elastic["costs_cold"], "costs_warm": elastic["costs_warm"],
        "flip_lambda_cold": (None if elastic["flip_cold"] is None
                             else elastic["flip_cold"][0]),
        "flip_lambda_warm": (None if elastic["flip_warm"] is None
                             else elastic["flip_warm"][0]),
        "wall_s": round(wall, 1)}))
    return rows


if __name__ == "__main__":
    main()
