"""Span-level trace report: a sharded step's measured time attributed to
the cost model's terms (the counterpart of ``benchmarks/trace_report.py``).

  PYTHONPATH=src python -m repro_torch.launch.trace_report --out TRACE.md
  PYTHONPATH=src python -m repro_torch.launch.trace_report --quick \
      --strategies fsdp --device cpu

For each strategy, on a ``dist.pool.Pool`` of ``--pool`` ranks laid out as
``perf.sweep.arch_mesh_axes`` (the reference's: smollm-360m reduced, fp32,
sgd, batch 8, seq 32), it runs the sharded train step under the span
recorder and reports:

* the **span breakdown** of the steady-state step (``dispatch`` and
  ``wait`` children of each ``step`` span, rank 0's), with the check that
  the children sum to within 10 % of the step;
* the **attribution table**: each ``op/axis/tensor`` term of the
  strategy's calibrated schedule, predicted by the α-β model and measured
  by running that term's collective alone on the same mesh axis with the
  same byte count (``obs.attribution.measure_collective_terms``: on ranks
  sharing one card, gloo's host round trips), with the compute term
  measured by ``train.step.RegionTimer``'s regions of the same step
  (``region_terms``: grad_compute + update, where the reference probes one
  device);
* the **drift verdict** (``detect_drift``) against the calibration band;
* the **disabled-recorder overhead** on the steady-state step: blocks of
  steps with a disabled recorder's spans and without, interleaved, the
  minimum of each side over the rounds. It is printed, not gated (host
  time spreads between runs).

It writes the markdown report only to ``--out``, when given; the last stdout
line is a JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

ARCH = "smollm-360m"
STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp")
B, S = 8, 32
STEPS = 8                # traced steady-state steps per strategy
OVERHEAD_ROUNDS = 10     # interleaved instrumented/plain rounds
OVERHEAD_BLOCK = 8       # steps a round times on each side
COVERAGE_TOL = 0.10      # children within 10 % of the step span


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="write the markdown report here")
    ap.add_argument("--strategies", default=",".join(STRATEGIES),
                    help="comma-separated strategy subset")
    ap.add_argument("--quick", action="store_true",
                    help="the first strategy only, 3 traced steps, 2 overhead "
                         "rounds of 1-step blocks")
    ap.add_argument("--pool", type=int, default=8, help="ranks of the world")
    ap.add_argument("--device", default="cuda")
    return ap


def _config():
    from repro_torch.configs import TrainConfig, get_config, reduced
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32",
                              param_dtype="float32")
    tcfg = TrainConfig(optimizer="sgd", beta1=0.0, grad_clip=1e9, total_steps=100,
                       warmup_steps=0, remat_policy="none", grad_compression="none")
    return cfg, tcfg


def trace_rank(ctx, cfg, tcfg, strategy: str, steps: int, rounds: int, block: int):
    """Pool job: a warm-up step, ``steps`` traced steps (rank 0's spans
    returned), two steps under the region timer, then the overhead rounds
    (every rank runs the same steps: each is a collective)."""
    import torch

    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import sync
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.obs import Recorder
    from repro_torch.obs.export import recorded
    from repro_torch.train import step as TS

    device, mesh = ctx.device, ctx.mesh
    state = TS.init_sharded_train_state(cfg, tcfg, mesh, strategy, device=device)
    step = TS.make_sharded_train_step(cfg, tcfg, mesh, strategy)
    timer = TS.RegionTimer(device)
    timed = TS.make_sharded_train_step(cfg, tcfg, mesh, strategy, timer=timer)
    batch = {k: v.to(device) for k, v in batch_shardings(
        make_batch_for(cfg, B, S, step=0), mesh).items()}
    state, m = step(state, batch)                    # warm-up
    sync(device)

    def run(rec, n, state):
        for i in range(n):
            with rec.span("step", category="train", step_num=i, phase="steady"):
                with rec.span("dispatch", category="train"):
                    state, m = step(state, batch)
                with rec.span("wait", category="train"):
                    sync(device)
                    float(m["loss"])
        return state

    rec = Recorder(enabled=True)
    state = run(rec, steps, state)
    for _ in range(2):
        state, _ = timed(state, batch)
    regions = {k: min(v) for k, v in timer.ms.items()}

    off = Recorder(enabled=False)

    def plain_block(state):
        t0 = time.perf_counter()
        for _ in range(block):
            state, m = step(state, batch)
            sync(device)
            float(m["loss"])
        return (time.perf_counter() - t0) / block, state

    def inst_block(state):
        t0 = time.perf_counter()
        state = run(off, block, state)
        return (time.perf_counter() - t0) / block, state

    t_plain, t_inst = [], []
    for r in range(rounds):
        # alternate the order so a slow drift of the host cannot pass for
        # the instrumentation's cost
        first, second = ((plain_block, inst_block) if r % 2 == 0
                         else (inst_block, plain_block))
        a, state = first(state)
        b, state = second(state)
        (t_plain if r % 2 == 0 else t_inst).append(a)
        (t_inst if r % 2 == 0 else t_plain).append(b)
    lo_p, lo_i = min(t_plain), min(t_inst)
    del state, step, timed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"trace": recorded(rec), "regions_ms": regions,
            "overhead": {"plain_ms": lo_p * 1e3, "instrumented_ms": lo_i * 1e3,
                         "rounds": rounds, "block": block,
                         "overhead": (lo_i - lo_p) / lo_p}}


def run_point(pool, strategy: str, calibration, *, steps: int, rounds: int,
              block: int):
    from repro_torch.dist.compression import WIRE_BITS
    from repro_torch.obs import (attribution_table, detect_drift,
                                 measure_collective_terms, predicted_step_ms,
                                 predicted_terms, span_coverage)
    from repro_torch.obs.attribution import region_terms
    from repro_torch.perf.costmodel import ScheduleInputs
    from repro_torch.perf.planner.space import model_comm_sizes
    from repro_torch.perf.sweep import arch_mesh_axes

    cfg, tcfg = _config()
    axes = arch_mesh_axes(strategy, pool.world)
    r0 = pool.run(trace_rank, cfg, tcfg, strategy, steps, rounds, block, mesh=axes)[0]
    cov = span_coverage(r0["trace"].spans, "step")
    step_ms = cov["parent_ms"] / max(cov["n"], 1)
    # each step's children against that step
    per_step = [span_coverage([s] + r0["trace"].children_of(s), "step")["coverage"]
                for s in r0["trace"].find("step")]
    pb, ab = model_comm_sizes(cfg, B, S)
    inp = ScheduleInputs(n_devices=pool.world, param_bytes=pb,
                         wire_bits=WIRE_BITS["none"], act_bytes=ab)
    measured = region_terms(r0["regions_ms"])
    pred = predicted_terms(strategy, inp, calibration=calibration, axes=axes)
    meas = measure_collective_terms(pool, strategy, inp, axes=axes)
    rows = attribution_table(pred, meas, measured_compute_ms=measured["compute_ms"])
    return {"strategy": strategy, "mesh": dict(axes), "steps": steps,
            "step_ms": step_ms, "coverage": cov["coverage"],
            "step_coverage": per_step,
            "children_ms": {k: v / max(cov["n"], 1)
                            for k, v in cov["children_ms"].items()},
            "regions_ms": r0["regions_ms"], "region_terms": measured,
            "rows": rows, "drift": detect_drift(rows, calibration),
            "decomp": predicted_step_ms(strategy, inp,
                                        compute_ms=measured["compute_ms"],
                                        calibration=calibration, axes=axes),
            "overhead": r0["overhead"]}


def render_md(points, calibration, card: str, wall_s: float) -> str:
    from repro_torch.obs import render_markdown
    lines = [
        "# Trace report: a sharded step's time attributed to the cost model's "
        "terms", "",
        f"`python -m repro_torch.launch.trace_report` on {card}: `{ARCH}` reduced "
        f"fp32, sgd, batch {B}, seq {S}; calibration `{calibration.label}`. "
        "Measured collectives are each term's collective alone over the pool's "
        "mesh axis (on ranks sharing one card: gloo's host round trips); the "
        "compute term is the step's `grad_compute` + `update` regions.", ""]
    for p in points:
        mesh = "×".join(f"{a}:{s}" for a, s in p["mesh"].items())
        kids = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(p["children_ms"].items()))
        o = p["overhead"]
        lines += [
            f"## {p['strategy']}  (mesh {mesh})", "",
            f"Steady-state step: **{p['step_ms']:.3f} ms** (mean over {p['steps']} "
            f"traced steps); children: {kids}; span coverage "
            f"**{p['coverage']:.4f}**. Regions (ms, best of 2): "
            f"{json.dumps({k: round(v, 3) for k, v in p['regions_ms'].items()})}.", "",
            render_markdown(p["rows"]), "",
            f"Model decomposition: compute {p['decomp']['compute_ms']:.3f} + exposed "
            f"comm {p['decomp']['exposed_comm_ms']:.3f} = "
            f"**{p['decomp']['total_ms']:.3f} ms** predicted vs {p['step_ms']:.3f} ms "
            f"measured; the regions' comm {p['region_terms']['comm_ms']:.3f} ms.", "",
            f"Drift: {p['drift'].message}", "",
            f"Disabled-recorder overhead: {o['overhead']:+.2%} (plain "
            f"{o['plain_ms']:.3f} vs instrumented {o['instrumented_ms']:.3f} ms a step, "
            f"min of {o['rounds']} interleaved {o['block']}-step blocks).", ""]
    lines += [f"Total wall time: {wall_s:.1f} s.", ""]
    return "\n".join(lines)


def main(argv=None, pool=None):
    """Run the report; returns the points. ``pool``, when given, is an open
    ``Pool`` (its world is the mesh's size), else one of ``--pool`` ranks is
    opened."""
    import contextlib

    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool
    from repro_torch.launch.serve import device_name
    from repro_torch.perf.costmodel import load_calibration

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cal = load_calibration()
    strategies = tuple(s for s in args.strategies.split(",") if s)
    if args.quick:
        strategies = strategies[:1]
    steps = 3 if args.quick else STEPS
    rounds, block = (2, 1) if args.quick else (OVERHEAD_ROUNDS, OVERHEAD_BLOCK)
    t0 = time.time()
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=args.pool, device=device)) as pool:
        points = [run_point(pool, s, cal, steps=steps, rounds=rounds, block=block)
                  for s in strategies]
    wall = time.time() - t0
    for p in points:
        if not p["rows"]:
            raise SystemExit(f"{p['strategy']}: empty attribution table")
        bad = [c for c in p["step_coverage"] if abs(1.0 - c) > COVERAGE_TOL]
        if bad:
            raise SystemExit(f"{p['strategy']}: child spans cover {bad} of their step "
                             f"spans (tolerance {COVERAGE_TOL})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(render_md(points, cal, device_name(device), wall))
        print(f"wrote {args.out}")
    print(json.dumps({
        "ok": True, "strategies": list(strategies),
        "coverage": {p["strategy"]: round(p["coverage"], 4) for p in points},
        "overhead": {p["strategy"]: round(p["overhead"]["overhead"], 4)
                     for p in points},
        "drift_flags": {p["strategy"]: len(p["drift"].flagged) for p in points},
        "rows": {p["strategy"]: [r.to_dict() for r in p["rows"]] for p in points},
        "wall_s": round(wall, 1)}))
    return points


if __name__ == "__main__":
    main()
