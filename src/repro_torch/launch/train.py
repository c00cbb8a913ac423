"""Training entry point, on a CUDA device unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --batch 8 --seq 512 --steps 8 --compression int8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --devices 4 --strategy fsdp_tp --compression int8_ef --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --devices 4 --strategy auto --report-comm --compression int8_ef

``--devices N`` (default 1) sets the world: with N > 1 a ``dist.pool.Pool``
of N ranks over gloo (under ``cuda`` every rank shares the card; under
``--device cpu`` they are CPU processes) of ``plan_remesh(N)``'s (data,
model) mesh, whose size is N rounded down to a power of two: ``--devices
6`` opens 4 ranks. ``--mode`` picks the step as the reference's
``_pick_mode`` does: "sharded" is ``make_sharded_train_step`` (the legacy
eager-gather body; each rank builds its own state from the seed on its
device and takes its rows of every batch), "gspmd" the reference's
jit-with-shardings step, which on one device is the single-device step and
with N > 1 is not ported (the run exits with the reference's reason);
"auto" takes the sharded step whenever it can. The reference forces a pool
of 8 placeholder host devices when none is asked for; the port's default
is one card, the single-device step.

``--strategy auto`` asks the planner (``perf.planner.choose_strategy``) to
rank the registry's strategies by their calibrated collective cost, with
feasibility (batch divisibility, the per-rank memory estimate) judged on
the mesh this run builds; it prints the reference's ``planner:`` line.
``--report-comm`` prints the cost model's per-step estimate for the
strategy run (``comm estimate [...]``). The calibration is
``load_calibration``'s: ``$REPRO_CALIBRATION`` when set, else the
checked-in artifact.

Weights are the port's own seeded random init, drawn on the device; the
batches are the reference's deterministic step-indexed tokens (and stub
frames for an encoder-decoder). The step updates the parameters, moments
and residuals in place, as the reference's jitted step donates its state.
``--remat`` is the block remat policy: none, full, or dots (the dense
products' outputs kept). The last stdout line is the report JSON, with the
keys of ``repro.launch.train``'s report (``arch steps first_loss
final_loss wall_s losses strategy mesh``) plus ``path`` and
``path_reason``, ``device``, ``step_ms`` (median over the steps after the
first, each timed on the host clock ending in a synchronise),
``tokens_per_s`` (batch × seq over that median), ``param_count`` and
``tree_params`` (the config's count and the weights' own, which differ for
a hybrid), per step the MoE ``aux`` loss and, with an MTP head,
``mtp_ce``, and ``planner`` (``--strategy auto``: the decision and every
candidate) and ``comm`` (``--report-comm``), the keys the ``--dry-run``
JSON carries too; a sharded run adds ``pool`` (ranks, backend, cards) and
``ranks``, one entry per rank: its device, peak memory, the median ms of
each region of its step (``gather_params``, ``grad_compute``,
``grad_reduce``, ``update``) and its kernel launches per step.
Checkpointing, fault tolerance and tracing are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np

from repro_torch.dist.sharding import STRATEGIES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8", "int8_ef"])
    ap.add_argument("--strategy", default="fsdp_tp",
                    choices=sorted(STRATEGIES) + ["auto"],
                    help="parallelism strategy of a sharded run; 'auto' defers "
                         "to the planner (perf.planner.choose_strategy), which "
                         "ranks the feasible registry strategies by calibrated "
                         "collective cost + memory headroom")
    ap.add_argument("--mode", default="auto", choices=["auto", "sharded", "gspmd"],
                    help="sharded = the manual-collectives step over the pool; "
                         "gspmd = the single-device step (one device only); "
                         "auto prefers sharded")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the world (all on one card under cuda)")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--dtype", default="",
                    help="override model compute/param dtype (e.g. float32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--report-comm", action="store_true",
                    help="estimate the per-step collective time from the "
                         "calibrated cost model (perf.costmodel) and report it")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the execution plan as JSON and exit")
    return ap


def _comm_estimate(cfg, args, n_dev: int):
    """The cost model's collective estimate for the run's strategy, through
    the shared prediction path (``perf.predict.estimate_comm``)."""
    from repro_torch.dist.compression import WIRE_BITS
    from repro_torch.perf.planner.space import model_comm_sizes
    from repro_torch.perf.predict import estimate_comm

    param_bytes, act_bytes = model_comm_sizes(cfg, args.batch, args.seq)
    return estimate_comm(args.strategy, n_dev, param_bytes,
                         wire_bits=WIRE_BITS[args.compression],
                         act_bytes=act_bytes, detail=True).to_dict()


def _pick_mode(args, tcfg, mesh, n_dev: int):
    """(path, reason): which step this run uses (the reference's rules)."""
    from repro_torch.train.step import n_batch_shards, sharded_batch_ok
    why_not = None
    if n_dev <= 1:
        why_not = "single device"
    elif tcfg.optimizer == "adafactor":
        why_not = "adafactor needs full-dim factored moments"
    elif not sharded_batch_ok(mesh, args.batch):
        why_not = (f"batch {args.batch} not divisible over the batch axes "
                   f"of mesh {dict(mesh)}")
    elif (args.batch // n_batch_shards(mesh)) % args.microbatches != 0:
        why_not = (f"per-device batch {args.batch // n_batch_shards(mesh)} "
                   f"not divisible by {args.microbatches} microbatches")
    if args.mode == "gspmd":
        return "gspmd", "requested"
    if args.mode == "sharded":
        if why_not:
            raise SystemExit(f"--mode sharded impossible: {why_not}")
        return "sharded", "requested"
    if why_not:
        return "gspmd", f"auto fallback: {why_not}"
    return "sharded", "auto"


def _configs(args):
    from repro_torch.configs import TrainConfig, get_config, reduced
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype, param_dtype=args.dtype)
    tcfg = TrainConfig(learning_rate=args.lr, optimizer=args.optimizer,
                       total_steps=args.steps, warmup_steps=args.steps // 10,
                       remat_policy=args.remat,
                       grad_compression=args.compression, seed=args.seed)
    return cfg, tcfg


def train_rank(ctx, cfg, tcfg, args):
    """Pool job: one rank of a sharded run. Builds this rank's state from
    the seed on its device, takes its rows of each step's global batch and
    runs the legacy body, timing its regions; returns the rank's losses,
    metrics, step times, region times, launches per step and peak memory
    (numbers only: no tensor leaves the rank)."""
    import torch

    from repro_torch.data import make_batch_for
    from repro_torch.dist import probes
    from repro_torch.launch.serve import device_name, sync
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.train.step import (RegionTimer, init_sharded_train_state,
                                        make_sharded_train_step)
    from repro_torch.tree import tree_size

    device, mesh = ctx.device, ctx.mesh
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = init_sharded_train_state(cfg, tcfg, mesh, args.strategy,
                                     seed=args.seed, device=device)
    timer = RegionTimer(device)
    step_fn = make_sharded_train_step(cfg, tcfg, mesh, args.strategy,
                                      microbatches=args.microbatches, timer=timer)
    out = {"rank": ctx.rank, "device": device_name(device),
           "tree_params_local": tree_size(state.params), "losses": [], "aux": [],
           "mtp_ce": [], "grad_norm": [], "step_s": [], "launches": []}
    for step in range(args.steps):
        batch = {k: v.to(device) for k, v in batch_shardings(
            make_batch_for(cfg, args.batch, args.seq, step=step, seed=args.seed),
            mesh).items()}
        probes.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({**probes.read_launches(),
                                "flash_by_design": probes.read_designs()})
        out["losses"].append(float(metrics["loss"]))
        out["aux"].append(float(metrics["aux"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        if "mtp_ce" in metrics:
            out["mtp_ce"].append(float(metrics["mtp_ce"]))
        if ctx.rank == 0 and step % args.log_every == 0:
            print(f"step {step:5d} loss {out['losses'][-1]:.4f} "
                  f"gnorm {out['grad_norm'][-1]:.3f} lr {metrics['lr']:.2e} "
                  f"{out['step_s'][-1] * 1e3:.0f}ms", flush=True)
    out["regions_ms"] = {k: v for k, v in timer.ms.items()}
    out["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None)
    return out


def _sharded_run(args, cfg, tcfg, device, mesh):
    """The sharded run over a pool of the mesh's ranks: (losses, step
    times, aux, mtp_ce, the report's extra keys)."""
    from repro_torch.dist.pool import Pool
    from repro_torch.dist.sharding import mesh_size
    with Pool(world=mesh_size(mesh), device=device) as pool:
        ranks = pool.run(train_rank, cfg, tcfg, args, mesh=mesh)
        backend = pool.backend
    r0 = ranks[0]
    per_rank = [{"rank": r["rank"], "device": r["device"],
                 "peak_mem_bytes": r["peak_mem_bytes"],
                 "regions_ms": {k: statistics.median(v[1:] or v)
                                for k, v in r["regions_ms"].items()},
                 "launches_per_step": r["launches"],
                 "step_ms": [round(t * 1e3, 3) for t in r["step_s"]]}
                for r in ranks]
    extra = {"pool": {"ranks": pool.world, "backend": backend,
                      "cards": 1 if device.type == "cuda" else 0},
             "ranks": per_rank}
    return r0["losses"], r0["step_s"], r0["aux"], r0["mtp_ce"], extra


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.data import make_batch_for
    from repro_torch.launch.mesh import plan_remesh
    from repro_torch.launch.serve import device_name, sync
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_size

    cfg, tcfg = _configs(args)
    device = resolve_device(args.device)
    n_dev = max(args.devices, 1)
    plan = plan_remesh(n_dev)
    mesh = plan.axes()
    decision = None
    if args.strategy == "auto":
        from repro_torch.perf.planner import choose_strategy
        # feasibility is judged on the mesh this run builds
        decision = choose_strategy(cfg, batch=args.batch, seq=args.seq,
                                   n_devices=n_dev, optimizer=args.optimizer,
                                   compression=args.compression,
                                   mesh_axes=dict(mesh))
        args.strategy = decision.strategy
        note = "" if decision.calibrated else "  [uncalibrated α-β defaults in use]"
        print(f"planner: --strategy auto -> {args.strategy} ({decision.reason}){note}",
              flush=True)
    path, path_reason = _pick_mode(args, tcfg, mesh, n_dev)
    print(f"device={device} ({device_name(device)}) arch={cfg.name} "
          f"params={cfg.param_count()} devices={n_dev} mesh={plan.mesh_shape} "
          f"strategy={args.strategy} path={path} ({plan.reason}; {path_reason})",
          flush=True)
    planned = {}                 # the planner's and cost model's report keys
    if args.report_comm:
        comm = planned["comm"] = _comm_estimate(cfg, args, n_dev)
        print(f"comm estimate [{comm['calibration']}]: {comm['per_step_ms']:.3f} "
              f"ms/step over {comm['mesh_axes']}", flush=True)
    if decision is not None:
        planned["planner"] = decision.to_dict()
    if path == "gspmd" and n_dev > 1:
        raise SystemExit(f"path gspmd ({path_reason}) over {n_dev} devices: "
                         "gspmd not ported (the port runs it on one device only)")
    if args.dry_run:
        out = {"dry_run": True, "arch": cfg.name, "device": str(device),
               "devices": n_dev, "mesh": list(plan.mesh_shape),
               "strategy": args.strategy, "compression": args.compression,
               "optimizer": args.optimizer, "path": path,
               "path_reason": path_reason, "steps": args.steps,
               "batch": args.batch, "seq": args.seq, **planned}
        print(json.dumps(out))
        return out

    t_run = time.time()
    extra = {}
    if path == "sharded":
        losses, step_times, aux, mtp_ce, extra = _sharded_run(
            args, cfg, tcfg, device, mesh)
        from repro_torch.models.model import param_shapes
        n_tree = tree_size(param_shapes(cfg))
    else:
        state = init_train_state(cfg, tcfg, seed=args.seed, device=device)
        n_tree = tree_size(state.params)
        step_fn = make_train_step(cfg, tcfg, microbatches=args.microbatches)
        losses, step_times, aux, mtp_ce = [], [], [], []
        for step in range(args.steps):
            batch = {k: v.to(device) for k, v in
                     make_batch_for(cfg, args.batch, args.seq, step=step,
                                    seed=args.seed).items()}
            sync(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            sync(device)
            dt = time.perf_counter() - t0
            step_times.append(dt)
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux"]))
            if "mtp_ce" in metrics:
                mtp_ce.append(float(metrics["mtp_ce"]))
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {metrics['lr']:.2e} {dt * 1e3:.0f}ms", flush=True)

    steady = step_times[1:] or step_times
    step_ms = statistics.median(steady) * 1e3 if steady else None
    out = {"arch": cfg.name, "steps": args.steps,
           "first_loss": losses[0] if losses else None,
           "final_loss": float(np.mean(losses[-10:])) if losses else None,
           "wall_s": round(time.time() - t_run, 1),
           "losses": losses,
           "strategy": args.strategy,
           "mesh": list(plan.mesh_shape), "path": path,
           "path_reason": path_reason,
           "device": device_name(device),
           "step_ms": step_ms,
           "tokens_per_s": (args.batch * args.seq / (step_ms / 1e3)
                            if step_ms else None),
           "param_count": cfg.param_count(), "tree_params": n_tree,
           "aux": aux, **planned, **extra}
    if mtp_ce:
        out["mtp_ce"] = mtp_ce
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
