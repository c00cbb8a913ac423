"""The scenario planner's CLI (``benchmarks/plan.py``): the fitted model
turned into launch recommendations, and, under ``--validate``, measured.

  PYTHONPATH=src python -m repro_torch.launch.plan --dry-run      # plan only
  PYTHONPATH=src python -m repro_torch.launch.plan --validate --out DIR
  PYTHONPATH=src python -m repro_torch.launch.plan --refit --rows ROWS \\
      --model-out MODEL

It enumerates the feasible (strategy × n_devices × batch × wire format)
launch space of a pinned LeNet-5 config over a pool of ``--pool`` ranks
(8, the reference's forced pool), predicts every point through the
planner's decomposed model (``perf.planner``: a fitted compute term, a
calibrated collective schedule, bands from the fit residuals), keeps the
Pareto frontier over time × device-seconds × memory headroom and prints
the constrained top-k plan with why each pick won; the line after it is
``{"planner_plan": ...}``, the reference's JSON.

The model is ``--model`` (default: the checked-in
``benchmarks/artifacts/planner_model.json``, fitted by the reference on its
host pool); its calibration is the one it carries, else
``load_calibration``'s (``$REPRO_CALIBRATION``, else the checked-in link).
``--refit`` fits it anew from ``--rows`` (sweep rows with measured sharded
times: ``python -m repro_torch.launch.fit_perfmodel --sharded --rows-out``)
on ``--device``, and writes it to ``--model-out``.

``--validate`` executes the slate: each pick's sharded LeNet iteration
(``perf.sweep.make_sharded_iteration``, mode "jit": compiled) over its
mesh's ranks of a ``dist.pool.Pool`` (gloo; under ``cuda`` every rank
shares the card), built and compiled once on each rank (a rank-side cache
keeps it between jobs), then timed in interleaved rounds: every round runs
every pick ``--iters`` times, each iteration started at a barrier of the
pick's ranks and ended by a synchronise of the device, a step taking its
slowest rank's time; a pick keeps its minimum. It prints
``{"planner_validation": metrics}`` (Kendall τ, top-1 regret, top-1 in the
measured top 3) and writes ``planner_validation.json`` and ``PLANNER.md``
into ``--out``.

Nothing is written without a path: ``--validate`` needs ``--out`` and a
fit (``--refit``, or a ``--model`` that does not exist) needs
``--model-out``, unless ``--dry-run`` is given, which measures nothing and
writes nothing. On ``cuda`` the run uses the card or fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, List, Sequence

# The rank-side cache of validation programs: a key -> (iteration, this
# rank's params, batch and dropout draws). Filled by ``prepare_program`` and
# emptied by ``release_programs``, on each rank of a pool.
_PROGRAMS: Dict = {}


def _ints(csv: str):
    return tuple(int(x) for x in csv.split(",") if x)


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs.lenet5 import (BATCH_SIZES, GRAD_COMPRESSIONS,
                                            OPTIMIZERS)
    from repro_torch.dist.sharding import STRATEGIES
    from repro_torch.perf.planner import OBJECTIVES
    from repro_torch.perf.planner.space import POOL_DEVICES

    ap = argparse.ArgumentParser(
        description="Plan (and optionally validate) launch configurations "
                    "from the fitted performance model")
    # search space
    ap.add_argument("--devices", default=",".join(map(str, POOL_DEVICES)),
                    help="comma list of candidate device counts")
    ap.add_argument("--batches", default=",".join(map(str, BATCH_SIZES)))
    ap.add_argument("--strategies", default=",".join(sorted(STRATEGIES)))
    ap.add_argument("--compressions", default=",".join(GRAD_COMPRESSIONS))
    # pinned intrinsics of the planned workload
    ap.add_argument("--n-filters", type=int, default=16)
    ap.add_argument("--kernel-size", type=int, default=5)
    ap.add_argument("--optimizer", default="sgd", choices=OPTIMIZERS)
    ap.add_argument("--dataset", default="mnist")
    # objective + constraints
    ap.add_argument("--objective", default="time",
                    choices=sorted(OBJECTIVES))
    ap.add_argument("--k", type=int, default=10,
                    help="slate size (>= 8 under --validate)")
    ap.add_argument("--max-devices", type=int, default=0)
    ap.add_argument("--min-batch", type=int, default=0)
    ap.add_argument("--mem-gb", type=float, default=1.0,
                    help="per-device memory budget the feasibility "
                         "estimate plans against")
    # model / calibration
    ap.add_argument("--model", default="",
                    help="planner model JSON (default: the checked-in "
                         "benchmarks/artifacts/planner_model.json)")
    ap.add_argument("--rows", default="",
                    help="sweep rows JSON to fit the model from (--refit)")
    ap.add_argument("--refit", action="store_true",
                    help="fit the compute model from --rows before planning")
    ap.add_argument("--model-out", default="",
                    help="write the fitted model here")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=300)
    # validation
    ap.add_argument("--validate", action="store_true",
                    help="execute the slate through the sharded iteration "
                         "and write its report into --out")
    ap.add_argument("--out", default="",
                    help="directory for --validate's PLANNER.md and "
                         "planner_validation.json")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed steps per pick per measurement round")
    ap.add_argument("--rounds", type=int, default=3,
                    help="interleaved measurement rounds; each pick keeps "
                         "its minimum step time over all rounds")
    ap.add_argument("--quick", action="store_true",
                    help="k=8, 3 iterations, 2 rounds, small refit budget")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan as JSON and exit without "
                         "measuring or writing files")
    # the port's
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model's predictions, the fit "
                         "and the validation's ranks")
    ap.add_argument("--pool", type=int, default=8,
                    help="ranks of the pool the space is planned for and "
                         "--validate measures on")
    return ap


def _must_fit(args) -> bool:
    """A model is fitted under ``--refit`` or when ``--model`` (default: the
    checked-in one) does not exist."""
    from repro_torch.perf.planner import default_model_path
    return args.refit or not os.path.exists(args.model or default_model_path())


def _load_or_fit_model(args, device):
    """The PlannerModel the flags name: ``--model`` (or the checked-in
    one), or one fitted from ``--rows`` (``_must_fit``)."""
    from repro_torch.perf.planner import (PlannerModel, default_model_path,
                                          fit_planner_model)

    model_path = args.model or default_model_path()
    if not _must_fit(args):
        return PlannerModel.load(model_path, device=device)
    if not args.rows:
        raise SystemExit(
            f"cannot fit the planner model: no --rows (and model "
            f"{model_path!r} {'refit asked' if args.refit else 'missing'}); "
            f"measure rows with `python -m repro_torch.launch.fit_perfmodel "
            f"--sharded --rows-out ROWS`")
    with open(args.rows) as f:
        rows = json.load(f)
    t0 = time.time()
    model = fit_planner_model(rows, seeds=tuple(range(args.seeds)),
                              maxiter=args.maxiter,
                              source=os.path.relpath(args.rows),
                              device=device)
    print(f"fitted planner compute model in {time.time() - t0:.0f}s "
          f"(held-out MAPE {model.compute_mape:.1%}; oversub k="
          f"{model.oversub_k:g}; {model.meta['decomposition']['n_rows']} "
          f"calibration rows, {model.meta['n_fit']} fit / "
          f"{model.meta['n_test']} test)", flush=True)
    if args.model_out and not args.dry_run:
        model.save(args.model_out)
        print(f"wrote {args.model_out}", flush=True)
    return model


# ---------------------------------------------------------------------------
# Validation: pool jobs and the slate measurement
# ---------------------------------------------------------------------------

def _graphs_allowed():
    """Dynamo's limit on graphs of one code object, raised to two for each
    cached program (a program's steps after its warm-up may recompile once
    for new strides): every cached program compiles the same body."""
    import torch
    limit = max(torch._dynamo.config.recompile_limit, 2 * len(_PROGRAMS) + 2)
    return torch._dynamo.config.patch(recompile_limit=limit)


def prepare_program(ctx, key, cfg, seed: int) -> float:
    """Pool job: build one pick's sharded iteration on this rank (mode
    "jit", the reference's; params and batch from ``seed``, this rank's
    blocks), run it once (the compile) and keep it in the rank's cache
    under ``key``; returns the seconds this took. Programs compiled before
    stay alive."""
    from repro_torch.data.synthetic import lenet_batch
    from repro_torch.launch.serve import sync
    from repro_torch.models.lenet import init_lenet
    from repro_torch.perf.sweep import make_sharded_iteration, sharded_inputs

    t0 = time.perf_counter()
    mesh, dev = ctx.mesh, ctx.device
    params = init_lenet(cfg, seed=seed, device=dev)
    batch = lenet_batch(cfg, step=0, seed=seed, batch=cfg.batch_size,
                        device=dev)
    it, specs, batch_spec = make_sharded_iteration(cfg, "jit", mesh, params,
                                                   reset=False)
    p, b, rng = sharded_inputs(cfg, mesh, specs, batch_spec, params, batch,
                               seed)
    with _graphs_allowed():
        p, _ = it(p, b, rng)                     # warm-up / compile
    sync(dev)
    _PROGRAMS[key] = (it, p, b, rng)
    return time.perf_counter() - t0


def time_program(ctx, key, iters: int) -> List[float]:
    """Pool job: this rank's seconds of ``iters`` steps of the cached
    program ``key`` on the same inputs, each started at a barrier of the
    mesh's ranks and ended by a synchronise of the device (so the whole
    output, not the loss alone, is done)."""
    import torch.distributed as dist

    from repro_torch.launch.serve import sync

    it, p, b, rng = _PROGRAMS[key]
    every = ctx.mesh.group(ctx.mesh.axis_names)
    times = []
    with _graphs_allowed():
        for _ in range(iters):
            if every is not None:
                dist.barrier(group=every)
            t0 = time.perf_counter()
            it(p, b, rng)
            sync(ctx.device)
            times.append(time.perf_counter() - t0)
    return times


def release_programs(ctx=None) -> None:
    """Pool job: empty this rank's cache and dynamo's graphs of it."""
    import torch
    _PROGRAMS.clear()
    torch.compiler.reset()


def measure_slate(picks: Sequence, iters: int, rounds: int,
                  pool) -> List[float]:
    """Execute every pick (``Prediction``s of LeNet points) on ``pool``:
    each pick's program built and compiled once on its mesh's ranks
    (``prepare_program``, pick i from seed 1000 + i as the reference's),
    then ``rounds`` interleaved rounds of ``iters``
    timed steps a pick (``time_program``), a step lasting as long as its
    slowest rank and a pick keeping its minimum step. Returns fixed-work
    milliseconds (``REF_SAMPLES`` samples) aligned with ``picks``. A rank's
    failure raises ``RankError``."""
    from repro_torch.perf.costmodel import mesh_axes_for
    from repro_torch.perf.sweep import REF_SAMPLES

    world = {"data": pool.world}
    meshes = [mesh_axes_for(p.point.strategy, p.point.n_devices)
              for p in picks]
    pool.run(release_programs, mesh=world)
    try:
        for i, (p, axes) in enumerate(zip(picks, meshes)):
            build_s = max(pool.run(prepare_program, i, p.point.cfg, 1000 + i,
                                   mesh=axes))
            print(f"  built {p.point.key()} on mesh {axes} in {build_s:.1f}s",
                  flush=True)
        measured = [float("inf")] * len(picks)
        for r in range(rounds):
            for i, axes in enumerate(meshes):
                per_rank = pool.run(time_program, i, iters, mesh=axes)
                slowest = [max(ts[j] for ts in per_rank) for j in range(iters)]
                measured[i] = min(measured[i], min(slowest) * 1e3)
            print(f"  round {r + 1}/{rounds} done", flush=True)
    finally:
        pool.run(release_programs, mesh=world)
    measured = [m * REF_SAMPLES / p.point.batch_size
                for m, p in zip(measured, picks)]
    for p, m in zip(picks, measured):
        print(f"  measured {p.point.key()}: {m:.3f}ms fixed-work "
              f"(predicted {p.time_ms:.3f}ms)", flush=True)
    return measured


def main(argv=None, pool=None):
    """Plan, and under ``--validate`` measure on ``pool`` (an open
    ``dist.pool.Pool``; else one of ``--pool`` ranks is opened)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.quick:
        args.k, args.iters, args.rounds = min(args.k, 8), 3, 2
        args.seeds, args.maxiter = 2, 150
    if args.validate:
        args.k = max(args.k, 8)
        if args.objective != "time":
            ap.error("--validate is defined on the fixed-work time objective "
                     "(the measured quantity); plan with other objectives "
                     "without --validate")
    if not args.dry_run:
        if args.validate and not args.out:
            ap.error("--validate writes its report: give --out DIR")
        if _must_fit(args) and not args.model_out:
            ap.error("a fitted model is written: give --model-out PATH "
                     "(or --dry-run)")

    from repro_torch import resolve_device
    from repro_torch.configs.lenet5 import LeNet5Config
    from repro_torch.perf.planner import (Constraints, enumerate_lenet_space,
                                          pareto_frontier, predict_points,
                                          ranking_metrics, render_plan,
                                          render_validation_md)
    from repro_torch.perf.planner.search import probe_slate, validation_slate

    device = resolve_device(args.device)
    n_pool = pool.world if pool is not None else args.pool
    base = LeNet5Config(n_filters=args.n_filters,
                        kernel_size=args.kernel_size,
                        optimizer=args.optimizer, dataset=args.dataset)
    budget = int(args.mem_gb * 2**30)

    model = _load_or_fit_model(args, device)
    t0 = time.time()
    feasible, skipped = enumerate_lenet_space(
        base, pool=n_pool, n_devices=_ints(args.devices),
        batches=_ints(args.batches),
        strategies=tuple(s for s in args.strategies.split(",") if s),
        compressions=tuple(c for c in args.compressions.split(",") if c),
        mem_budget_bytes=budget)
    preds = predict_points(model, feasible)
    frontier = pareto_frontier(preds)
    constraints = Constraints(max_devices=args.max_devices or None,
                              min_batch=args.min_batch or None)
    picks = validation_slate(preds, args.k, objective=args.objective,
                             constraints=constraints)
    n_space = len(feasible) + len(skipped)
    plan_text = render_plan(picks, frontier, model, objective=args.objective,
                            n_space=n_space, n_feasible=len(feasible))
    print(plan_text, flush=True)

    plan_blob = {
        "pool": n_pool, "objective": args.objective, "k": args.k,
        "space": n_space, "feasible": len(feasible),
        "skipped": [{"point": list(p.key()), "reasons": list(f.reasons)}
                    for p, f in skipped[:20]],
        "frontier_size": len(frontier),
        "frontier": [p.to_dict() for p in frontier[:10]],
        "top": [p.to_dict() for p in picks],
        "calibration": model.calibration.label,
        "calibrated": model.calibrated,
        "compute_mape": model.compute_mape,
        "plan_seconds": round(time.time() - t0, 1),
    }
    print(json.dumps({"planner_plan": plan_blob}), flush=True)
    if args.dry_run or not args.validate:
        return plan_blob

    # -- validation: execute the slate ----------------------------------------
    # contrast probes stretch the slate across the predicted spectrum; they
    # sample the constrained pool so no probe outranks the picks and takes
    # slate index 0 (whose metrics are the planner's gate)
    probes = probe_slate(constraints.apply(preds), objective=args.objective,
                         exclude=picks)
    tagged = sorted([(p, "pick") for p in picks]
                    + [(p, "probe") for p in probes],
                    key=lambda pr: pr[0].time_ms)
    slate = [p for p, _ in tagged]
    roles = [r for _, r in tagged]
    print(f"validating {len(picks)} picks + {len(probes)} probes through the "
          f"sharded iteration over a pool of {n_pool} ranks on {device} "
          f"({args.rounds} rounds × {args.iters} iterations)...", flush=True)
    t1 = time.time()
    from repro_torch.dist.pool import Pool
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=n_pool, device=device)) as pool:
        measured_ms = measure_slate(slate, args.iters, args.rounds, pool)
    metrics = ranking_metrics([p.time_ms for p in slate], measured_ms)
    print(json.dumps({"planner_validation": metrics}), flush=True)

    os.makedirs(args.out, exist_ok=True)
    out = {"plan": plan_blob, "metrics": metrics,
           "measured_ms": measured_ms, "roles": roles,
           "slate": [p.to_dict() for p in slate],
           "iters": args.iters, "rounds": args.rounds,
           "device": str(device),
           "validate_seconds": round(time.time() - t1, 1)}
    with open(os.path.join(args.out, "planner_validation.json"), "w") as f:
        json.dump(out, f, indent=1, default=float)
    protocol = (f"programs compiled once, then {args.rounds} interleaved "
                f"rounds × {args.iters} steps, minimum step time")
    md = render_validation_md(
        slate, measured_ms, metrics, model, objective=args.objective,
        pool=n_pool, n_space=n_space, n_feasible=len(feasible),
        n_frontier=len(frontier), protocol=protocol, plan_text=plan_text,
        roles=roles)
    report = os.path.join(args.out, "PLANNER.md")
    with open(report, "w") as f:
        f.write(md)
    print(f"wrote {report}", flush=True)
    return out


if __name__ == "__main__":
    main()
