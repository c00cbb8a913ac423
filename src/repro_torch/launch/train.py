"""Training entry point, on a CUDA device unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --batch 8 --seq 512 --steps 8 --compression int8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --devices 4 --strategy fsdp_tp --compression int8_ef --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --devices 4 --strategy auto --report-comm --compression int8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --devices 4 --mode gspmd --strategy fsdp_tp --compression int8_ef

``--devices N`` (default 1) sets the world: with N > 1 a ``dist.pool.Pool``
of N ranks over gloo (under ``cuda`` every rank shares the card; under
``--device cpu`` they are CPU processes) of ``plan_remesh(N)``'s (data,
model) mesh, whose size is N rounded down to a power of two: ``--devices
6`` opens 4 ranks. ``--mode`` picks the step as the reference's
``_pick_mode`` does: "sharded" is ``make_sharded_train_step`` (the legacy
eager-gather body; each rank builds its own state from the seed on its
device and takes its rows of every batch), "gspmd" the reference's
jit-with-shardings step, which on one device is the single-device step and
over N > 1 ranks ``make_gspmd_train_step`` (each rank holds its slices of
the state as ``launch.specs.state_shardings`` places them and takes the
global batch, of which it computes its rows; ``train.serve`` sets out the
design); "auto" takes the sharded step whenever it can, and every one of
the reference's fallbacks (adafactor, a batch the batch axes do not
divide, microbatches that do not divide a rank's rows) the GSPMD step. The
reference forces a pool of 8 placeholder host devices when none is asked
for; the port's default is one card, the single-device step.

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
a hybrid), per step the MoE ``aux`` loss, the gradients' global norm
before the clip (``grad_norm``, rank 0's of a sharded run) and, with an MTP
head, ``mtp_ce``, and ``planner`` (``--strategy auto``: the decision and every
candidate) and ``comm`` (``--report-comm``), the keys the ``--dry-run``
JSON carries too; a sharded run adds ``pool`` (ranks, backend, cards) and
``ranks``, one entry per rank: its device, peak memory, the median ms of
each region of its step (``gather_params``, ``grad_compute``,
``grad_reduce``, ``update``) and its kernel launches per step; a GSPMD
rank adds the bytes its step holds beyond its state's slices
(``transient_bytes``).

Checkpoints, the failure drill and tracing, as the reference's production
loop (``repro.launch.train``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --devices 8 --strategy fsdp --ckpt-dir /tmp/run --ckpt-every 2 \
      --simulate-failure 4 --recover-strategy tp --trace-dir /tmp/trace

``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps and at the end
(``train.checkpoint``: one device writes the full format, a pool the sharded
one, every rank's blocks gathered to rank 0), each write under the
supervisor's retry policy (``train.supervisor``; ``--max-retries``,
``--inject-ckpt-fault N`` fails the first N writes), and resumes from the
newest verified checkpoint it finds (``resumed from step N``).
``--die-at-step`` exits with code 42 at that step. ``--simulate-failure S``
loses ``--fail-devices`` ranks (half by default) at step S: the job on the
first mesh stops there, rank 0 (this process) plans the recovery
(``ft.plan_recovery``: ``--recover-strategy`` or the planner's pick on the
survivors, ``plan_remesh``'s mesh ranked by ``perf.planner.remesh_predict``)
and a second job on the survivors' smaller mesh restores the checkpoint,
each rank reading only its slice (shard to shard), and runs on; the report's
``recovery`` has the reference's keys. ``--precompile-survivors N`` builds
the survivor mesh's program (the plan, mesh, specs and state skeleton) in a
background thread of every surviving rank after the first step, so the
recovery skips that work (``compile_s`` is the wait for it left exposed;
``--precompile-block`` waits for it). ``--straggler-tol`` flags steps
slower than the running median (``ft.StragglerDetector`` through
``obs.StragglerMonitor``), ``--straggler-escalate K`` checkpoints after K
flagged steps in a row. ``--trace-dir`` records each rank's spans (``step``
with ``data``, ``dispatch``, ``wait``; ``recovery/{compile,plan,rebuild,
restore}``) and writes ``trace.jsonl`` (rank 0's, the reference's schema,
with the metrics) and ``trace_chrome.json`` (every rank, pid = rank);
``--trace-sync boundary`` synchronises at span boundaries,
``--trace-annotate`` passes step spans through
``torch.profiler.record_function``. The report adds ``supervisor``,
``checkpoints`` (each write's bytes and seconds), ``recovery``,
``straggler_flags`` and, traced, ``trace`` and ``metrics``.
``--dry-run --simulate-failure`` prints the recovery plan.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

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
                         "gspmd = the reference's jit-with-shardings step (one "
                         "device: the single-device step; over the pool: "
                         "train.step.make_gspmd_train_step); auto prefers sharded")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the world (all on one card under cuda)")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--dtype", default="",
                    help="override model compute/param dtype (e.g. float32 for "
                         "bit-parity recovery drills)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-tol", type=float, default=2.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--die-at-step", type=int, default=0,
                    help="fault injection: exit with code 42 at this step")
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="fault injection: at this step, lose ranks, re-plan "
                         "(strategy, mesh) on the survivors via "
                         "ft.plan_recovery, restore the latest checkpoint "
                         "cut for them, and resume (requires --ckpt-dir)")
    ap.add_argument("--fail-devices", type=int, default=0,
                    help="ranks lost at --simulate-failure (0 = half the world)")
    ap.add_argument("--recover-strategy", default="auto",
                    choices=sorted(STRATEGIES) + ["auto"],
                    help="strategy after the simulated failure; auto = the "
                         "planner's pick on the surviving ranks")
    ap.add_argument("--precompile-survivors", type=int, default=0,
                    help="build the survivor mesh's program (plan, mesh, specs, "
                         "state skeleton, step) for the N largest pow2-floor "
                         "survivor counts in a background thread while training "
                         "runs, so a recovery skips that work (0 = off)")
    ap.add_argument("--precompile-block", action="store_true",
                    help="at recovery, wait for the background build to land "
                         "instead of building cold (a failure arriving in "
                         "steady state)")
    ap.add_argument("--inject-ckpt-fault", type=int, default=0,
                    help="fault injection: the first N checkpoint writes raise "
                         "a transient OSError (the supervisor's retry path)")
    ap.add_argument("--max-retries", type=int, default=4,
                    help="supervisor retry budget (attempts, not re-tries) for "
                         "transient checkpoint-I/O failures")
    ap.add_argument("--straggler-escalate", type=int, default=0,
                    help="K consecutive straggler-flagged steps trigger a "
                         "proactive checkpoint (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--report-comm", action="store_true",
                    help="estimate the per-step collective time from the "
                         "calibrated cost model (perf.costmodel) and report it")
    ap.add_argument("--trace-dir", default="",
                    help="record spans/metrics and write trace.jsonl + "
                         "trace_chrome.json here; empty (default) keeps the "
                         "zero-overhead disabled recorder")
    ap.add_argument("--trace-sync", default="none", choices=["none", "boundary"],
                    help="device-sync policy at span boundaries: 'none' adds no "
                         "synchronise the untraced loop lacks; 'boundary' "
                         "synchronises for precise span durations")
    ap.add_argument("--trace-annotate", action="store_true",
                    help="pass step spans through torch.profiler.record_function "
                         "(groups device activity by step in a torch.profiler "
                         "trace)")
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


# ---------------------------------------------------------------------------
# The state's placement, checkpoint view and restore skeleton, per path
# ---------------------------------------------------------------------------

def _batch_entry(axes):
    from repro_torch.train.step import _mesh_batch_axes
    batch = _mesh_batch_axes(axes)
    return batch if len(batch) > 1 else batch[0]


def _ckpt_layout(cfg, tcfg, axes, strategy: str, path: str):
    """(skeleton, specs) of the state a checkpoint holds for this path, from
    shapes only: the whole-state skeleton (``init_train_state``'s tensors as
    fake tensors) and the spec tree it is placed by; None specs on one
    device (a full save). The sharded path's error-feedback residuals are
    each rank's own: the checkpoint stacks them ``[n_batch_shards, ...]``
    over the batch axes, as the reference's per-rank buffer, so a restore
    onto another count of batch shards re-initialises them (the report's
    ``reinit_leaves``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim.optimizers import OptState
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_map
    with FakeTensorMode():
        whole = TS.init_train_state(cfg, tcfg, device="cpu")
    if axes is None:
        return whole, None
    if path == "gspmd":
        return whole, TS.gspmd_state_specs(cfg, tcfg, axes, strategy, shapes=whole.params)
    specs = TS.sharded_state_specs(cfg, tcfg, axes, strategy, shapes=whole.params)
    ef_skel = ef_specs = None
    if whole.ef is not None:
        n_b = TS.n_batch_shards(axes)
        entry = _batch_entry(axes)
        ef_skel = tree_map(lambda x: CK.ShapeDtype((n_b,) + tuple(x.shape), x.dtype),
                           whole.ef)
        ef_specs = tree_map(lambda x: (entry,), whole.ef)
    return (TS.TrainState(whole.params, OptState(0, whole.opt.mu, whole.opt.nu), ef_skel),
            TS.TrainState(specs.params, specs.opt, ef_specs))


def _ckpt_view(state, path: str, mesh):
    """The state as the checkpoint holds it (the sharded path's residuals
    stacked, a view), and back (``unview``)."""
    from repro_torch.train.step import TrainState
    from repro_torch.tree import tree_map
    if mesh is None or path == "gspmd" or state.ef is None:
        return state
    return TrainState(state.params, state.opt, tree_map(lambda x: x[None], state.ef))


def _ckpt_unview(state, path: str, mesh):
    from repro_torch.train.step import TrainState
    from repro_torch.tree import tree_map
    if mesh is None or path == "gspmd" or state.ef is None:
        return state
    return TrainState(state.params, state.opt, tree_map(lambda x: x[0], state.ef))


def _make_step(cfg, tcfg, args, mesh, strategy: str, path: str, timer):
    """(init, step): this rank's state from the seed and the step, for the
    path (``mesh`` None: the single-device step)."""
    from repro_torch.train import step as TS
    if mesh is None:
        return (lambda device: TS.init_train_state(cfg, tcfg, seed=args.seed,
                                                   device=device),
                TS.make_train_step(cfg, tcfg, microbatches=args.microbatches))
    if path == "gspmd":
        return (lambda device: TS.init_gspmd_train_state(
                    cfg, tcfg, mesh, strategy, seed=args.seed, device=device),
                TS.make_gspmd_train_step(cfg, tcfg, mesh, strategy,
                                         microbatches=args.microbatches, timer=timer))
    return (lambda device: TS.init_sharded_train_state(
                cfg, tcfg, mesh, strategy, seed=args.seed, device=device),
            TS.make_sharded_train_step(cfg, tcfg, mesh, strategy,
                                       microbatches=args.microbatches, timer=timer))


# ---------------------------------------------------------------------------
# Per-process state of a run: the entry point's objects on rank 0 (the caller's
# process), each spawned rank's own, kept between the run's pool jobs
# ---------------------------------------------------------------------------

_RUN: Dict[str, Any] = {}


def _run_state(args, rank: int):
    """This process's recorder, metrics, supervisor, checkpoint manager,
    survivor builds and monitor for the run ``args.run_id``: rank 0's are
    ``main``'s; a spawned rank makes its own on its
    first job of the run and keeps them for the next."""
    from repro_torch.obs import Metrics, Recorder, StragglerMonitor
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.ft import StragglerDetector
    from repro_torch.train.supervisor import (RetryPolicy, Supervisor,
                                              SurvivorPrecompiler)
    if _RUN.get("run_id") == args.run_id:
        return _RUN
    _RUN.clear()
    rec = Recorder(enabled=bool(args.trace_dir), sync_policy=args.trace_sync,
                   annotate=args.trace_annotate)
    metrics = Metrics()
    fault_hook = None
    if rank == 0 and args.inject_ckpt_fault > 0:
        budget = {"n": args.inject_ckpt_fault}

        def fault_hook(op, at_step):
            if op == "write" and budget["n"] > 0:
                budget["n"] -= 1
                raise OSError(f"injected transient ckpt fault at step {at_step} "
                              f"({budget['n']} remaining)")
    _RUN.update(
        run_id=args.run_id, rec=rec, metrics=metrics,
        sup=Supervisor(policy=RetryPolicy(max_attempts=max(args.max_retries, 1)),
                       recorder=rec, metrics=metrics,
                       escalate_after=max(args.straggler_escalate, 1)),
        ckpt=(CheckpointManager(args.ckpt_dir, keep=3, fault_hook=fault_hook)
              if args.ckpt_dir else None),
        precomp=(SurvivorPrecompiler(recorder=rec, metrics=metrics)
                 if args.precompile_survivors > 0 else None),
        monitor=StragglerMonitor(StragglerDetector(tolerance=args.straggler_tol),
                                 metrics=metrics, recorder=rec),
        writes=[], submitted=False)
    return _RUN


def _survivor_build(cfg, tcfg, args, n: int):
    """The survivor mesh's program for ``n`` ranks, as recovery would build
    it: the ``plan_recovery`` decision (no compute reference, as the
    reference's precompile), the mesh, the path, and the checkpoint layout
    (skeleton and specs). The step closure is bound to the mesh's process
    groups when the survivors' job starts, where the world makes them."""
    import argparse as _ap

    from repro_torch.train.ft import plan_recovery
    rplan = plan_recovery(cfg, n, batch=args.batch, seq=args.seq,
                          optimizer=args.optimizer, compression=args.compression,
                          strategy=(None if args.recover_strategy == "auto"
                                    else args.recover_strategy))
    axes = rplan.axes()
    ns = _ap.Namespace(**vars(args))
    ns.strategy = rplan.strategy
    path, why = _pick_mode(ns, tcfg, axes, rplan.n_devices)
    layout = _ckpt_layout(cfg, tcfg, axes if rplan.n_devices > 1 else None,
                          rplan.strategy, path)
    return rplan, (axes, path, why, layout)


def _submit_survivor_builds(run, cfg, tcfg, args, n_dev: int, rank: int) -> None:
    """Queue the builds for the N largest pow2 survivor counts this rank is
    among."""
    from repro_torch.train.supervisor import pow2_floor
    n_surv = pow2_floor(n_dev)
    for _ in range(args.precompile_survivors):
        n_surv //= 2
        if n_surv < 1:
            break
        if rank < n_surv:
            run["precomp"].submit((n_surv,), lambda n=n_surv: _survivor_build(
                cfg, tcfg, args, n))


# ---------------------------------------------------------------------------
# One segment of the run on one rank (or the single device)
# ---------------------------------------------------------------------------

def _agree_step(step: int, mesh) -> int:
    """The lowest step the mesh's ranks restored."""
    from repro_torch.dist.sharding import all_reduce
    if mesh is None or mesh.size == 1:
        return step
    t = torch.tensor([-float(step)])
    return int(-all_reduce(t, "max", mesh.group(mesh.axis_names)).item())


def _any_rank(flag: bool, mesh) -> bool:
    from repro_torch.dist.sharding import all_reduce
    if mesh is None or mesh.size == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0])
    return bool(all_reduce(t, "max", mesh.group(mesh.axis_names)).item() > 0)


def train_rank(ctx, cfg, tcfg, args, path: str = "sharded", seg=None):
    """One segment of a run on one rank (a pool job; the single device runs
    it in place with ``ctx.mesh`` None): build this rank's state (from the
    seed, or restored from the checkpoint: auto-resume, or a recovery's
    restore cut for this mesh), run steps from there up to ``seg["stop"]``
    (or up to a failure or death step, where it stops) with each step's
    spans (``step``, children ``data``, ``dispatch``, ``wait``), checkpoints
    every ``--ckpt-every`` steps, and return the rank's numbers (losses,
    metrics and times by step, region times, launches per step, peak
    memory), its spans (a spawned rank's; rank 0 records into ``main``'s
    recorder) and rank 0's recovery and checkpoint measurements. No tensor
    leaves the rank."""
    import time as _time
    from contextlib import nullcontext

    from repro_torch.data import make_batch_for
    from repro_torch.dist import probes
    from repro_torch.launch.serve import device_name, sync
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.obs import observe_step, record_memory_watermarks
    from repro_torch.obs.export import recorded
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_size

    seg = {"start": 0, "stop": args.steps, "strategy": args.strategy, "recovery": None,
           "resume": True, **(seg or {})}
    device, mesh = ctx.device, ctx.mesh
    rank0 = ctx.rank == 0
    run = _run_state(args, ctx.rank)
    rec, metrics, ckpt, sup = run["rec"], run["metrics"], run["ckpt"], run["sup"]
    strategy = seg["strategy"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timer = TS.RegionTimer(device) if mesh is not None else None
    out = {"rank": ctx.rank, "device": device_name(device), "losses": {}, "aux": {},
           "mtp_ce": {}, "grad_norm": {}, "step_s": [], "launches": [],
           "stopped": None}
    recovery = seg["recovery"]
    prog = seg.get("prog")

    # ---- build: the step, the state (seeded, or restored) -------------------
    axes = None if mesh is None else dict(mesh.shape)
    layout = None
    if prog and run["precomp"] is not None:
        # the survivor build rank 0 recovered with, if this rank has it too
        got = run["precomp"].get(seg["n_survivors"], block=True, timeout=600.0)
        if (got is not None and got.plan.strategy == strategy
                and got.bundle[:2] == ((axes or {"data": 1, "model": 1}), path)):
            layout = got.bundle[3]
    rebuild = (rec.span("recovery/rebuild", category="recovery", step_num=seg["start"])
               if recovery is not None and layout is None else nullcontext())
    with rebuild:
        init, step_fn = _make_step(cfg, tcfg, args, mesh, strategy, path, timer)
        if layout is None and ckpt is not None:
            layout = _ckpt_layout(cfg, tcfg, axes, strategy, path)
    place = ((lambda b: batch_shardings(b, mesh)) if mesh is not None and path == "sharded"
             else (lambda b: b))
    state, step = None, seg["start"]
    if ckpt is not None and seg["resume"] and ckpt.latest_step() is not None:
        skel, specs = layout
        placement = None if mesh is None else CK.Placement(mesh, specs, device)
        span = (rec.span("recovery/restore", category="recovery", step_num=seg["start"])
                if recovery is not None else nullcontext())
        with span:
            state, step = ckpt.restore(skel, shardings=placement, strict=False,
                                       device=device)
            agreed = _agree_step(step, mesh)
            if agreed != step:
                state, step = ckpt.restore(skel, agreed, shardings=placement,
                                           strict=False, device=device)
            state = _ckpt_unview(state, path, mesh)
            sync(device)
        out["restored"] = {"step": step, "reinit_leaves": list(ckpt.last_restore_report),
                           "mode": ckpt.last_restore_mode}
        if recovery is not None:
            out["restore_s"] = _time.perf_counter() - recovery["t1"]
        elif rank0:
            if ckpt.last_restore_report:
                print(f"restore re-initialized {len(ckpt.last_restore_report)} "
                      f"leaves: {ckpt.last_restore_report[:4]}...", flush=True)
            print(f"resumed from step {step}", flush=True)
    if state is None:
        state = init(device)
    out["tree_params_local"] = tree_size(state.params)

    def save(at_step):
        """Checkpoint ``at_step``: every rank's blocks to rank 0, whose write
        runs under the supervisor (a transient failure re-runs the write)."""
        view = _ckpt_view(state, path, mesh)
        extra = {"arch": cfg.name}
        if mesh is None:
            collected = CK._flatten_with_paths(view), {
                "step": int(at_step), "time": _time.time(), "format": CK.FORMAT_FULL,
                **extra}
        else:
            collected = ckpt.collect_sharded(at_step, view, mesh=mesh, strategy=strategy,
                                             specs=layout[1], extra_meta=extra)
        if collected is None:
            return
        retries = sup.retries

        def write():
            ckpt.write(at_step, *collected)
            ckpt.wait()
        sup.run("checkpoint_save", write)
        run["writes"].append({**ckpt.last_write, "retries": sup.retries - retries})

    # ---- the steps -------------------------------------------------------------
    phase = seg.get("phase", "warmup")
    fail_at, die_at = seg.get("fail_at", 0), args.die_at_step
    while step < seg["stop"]:
        if die_at and step == die_at:
            out["stopped"] = ("die", step)
            break
        if fail_at and step >= fail_at:
            out["stopped"] = ("failure", step)
            break
        with rec.span("step", category="train", step_num=step, phase=phase) as sp:
            with rec.span("data", category="train"):
                batch = {k: v.to(device) for k, v in place(make_batch_for(
                    cfg, args.batch, args.seq, step=step, seed=args.seed)).items()}
                launched = probes.read_launches(), probes.read_designs()
                sync(device)
            t0 = _time.perf_counter()
            with rec.span("dispatch", category="train"):
                state, m = step_fn(state, batch)
            with rec.span("wait", category="train"):
                # the synchronise the untraced loop takes: the span times it
                sync(device)
                loss = float(m["loss"])
            dt = _time.perf_counter() - t0
            sp.set(ms=dt * 1e3)
        out["step_s"].append(dt)
        # this step's launches: the counters read before and after it (a
        # caller's count over the whole run stays whole)
        out["launches"].append({
            **{k: v - launched[0][k] for k, v in probes.read_launches().items()},
            "flash_by_design": {k: v - launched[1][k]
                                for k, v in probes.read_designs().items()}})
        out["losses"][step] = loss
        out["aux"][step] = float(m["aux"])
        out["grad_norm"][step] = float(m["grad_norm"])
        if "mtp_ce" in m:
            out["mtp_ce"][step] = float(m["mtp_ce"])
        if recovery is not None and "first_step_s" not in out:
            out["first_step_s"] = dt
        if run["precomp"] is not None and not run["submitted"]:
            # after the first healthy step, so the build does not contend
            # with it (once a run)
            run["submitted"] = True
            _submit_survivor_builds(run, cfg, tcfg, args,
                                    1 if mesh is None else mesh.size, ctx.rank)
        flagged = run["monitor"].observe(step, dt) if rank0 else False
        if (ckpt is not None and args.straggler_escalate
                and _any_rank(rank0 and sup.note_straggler(step, flagged), mesh)):
            # a persistently slow step is a failure precursor: snapshot now
            save(step + 1)
            if rank0:
                print(f"proactive checkpoint at step {step} (persistent straggler)",
                      flush=True)
        if rank0 and rec.enabled:
            observe_step(metrics, seconds=dt, batch=args.batch, seq=args.seq)
            for k, v in seg.get("comm_terms", {}).items():
                metrics.counter(f"comm_bytes/{k}").inc(v)
            if step % args.log_every == 0:
                record_memory_watermarks(metrics, [device])
        phase = "steady"
        if rank0 and (step % args.log_every == 0 or flagged):
            msg = (f"step {step:5d} loss {loss:.4f} gnorm {out['grad_norm'][step]:.3f} "
                   f"lr {float(m['lr']):.2e} {dt * 1e3:.0f}ms")
            print(msg + ("  [STRAGGLER FLAGGED]" if flagged else ""), flush=True)
        step += 1
        if ckpt is not None and step % args.ckpt_every == 0 and step < args.steps:
            save(step)
    if ckpt is not None and out["stopped"] is None and step >= args.steps:
        save(args.steps)
    if rank0 and rec.enabled:
        record_memory_watermarks(metrics, [device])
    out["regions_ms"] = {} if timer is None else {k: v for k, v in timer.ms.items()}
    out["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None)
    out["transient_bytes"] = getattr(step_fn, "transient_bytes", None)
    if not rank0:
        out["trace"] = recorded(rec)
    del state, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def _comm_byte_terms(cfg, args, strategy, axes, n_dev):
    """Per-collective bytes of one step (``op/axis/tensor``) for the
    ``comm_bytes/*`` counters, recomputed when (strategy, mesh) changes."""
    from repro_torch.dist.compression import WIRE_BITS
    from repro_torch.obs import collective_bytes
    from repro_torch.perf.planner.space import model_comm_sizes
    pb, ab = model_comm_sizes(cfg, args.batch, args.seq)
    return collective_bytes(strategy, n_dev, pb, wire_bits=WIRE_BITS[args.compression],
                            act_bytes=ab, axes=dict(axes))


def _merge_rank(acc: Dict[int, Dict], r: Dict) -> None:
    """Fold one segment's rank result into the run's per-rank record."""
    a = acc.setdefault(r["rank"], {"rank": r["rank"], "device": r["device"],
                                   "peak_mem_bytes": None, "regions_ms": {},
                                   "launches_per_step": [], "step_ms": []})
    if r["peak_mem_bytes"] is not None:
        a["peak_mem_bytes"] = max(a["peak_mem_bytes"] or 0, r["peak_mem_bytes"])
    for k, v in r["regions_ms"].items():
        a["regions_ms"].setdefault(k, []).extend(v)
    a["launches_per_step"] += r["launches"]
    a["step_ms"] += [round(t * 1e3, 3) for t in r["step_s"]]
    if r["transient_bytes"] is not None:
        a["transient_bytes"] = r["transient_bytes"]
    if "trace" in r:
        a["trace"] = r["trace"]


def main(argv=None, pool=None):
    """Train; returns the report. ``pool``, when given, is the open ``Pool``
    a run over N > 1 ranks uses (its world holds the mesh), else one of the
    mesh's ranks is opened."""
    import contextlib
    import os
    import uuid

    args = build_parser().parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool, RankContext
    from repro_torch.dist.sharding import mesh_size
    from repro_torch.launch.mesh import plan_remesh
    from repro_torch.launch.serve import device_name
    from repro_torch.models.model import param_shapes
    from repro_torch.obs import record_recovery, write_jsonl
    from repro_torch.obs.export import write_chrome_trace, write_chrome_trace_ranks
    from repro_torch.train.ft import plan_recovery, survivors
    from repro_torch.train.step import n_batch_shards
    from repro_torch.tree import tree_size

    cfg, tcfg = _configs(args)
    if args.simulate_failure and not args.dry_run and not args.ckpt_dir:
        raise SystemExit("--simulate-failure requires --ckpt-dir "
                         "(recovery restores from the latest checkpoint)")
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
    if args.dry_run:
        out = {"dry_run": True, "arch": cfg.name, "device": str(device),
               "devices": n_dev, "mesh": list(plan.mesh_shape),
               "strategy": args.strategy, "compression": args.compression,
               "optimizer": args.optimizer, "path": path,
               "path_reason": path_reason, "steps": args.steps,
               "batch": args.batch, "seq": args.seq, **planned}
        if args.simulate_failure:
            # plan (but do not run) the recovery, so a drill can be inspected
            lost = args.fail_devices or n_dev // 2
            rplan = plan_recovery(
                cfg, survivors(n_dev, lost), batch=args.batch, seq=args.seq,
                optimizer=args.optimizer, compression=args.compression,
                strategy=(None if args.recover_strategy == "auto"
                          else args.recover_strategy))
            out["recovery"] = {"at_step": args.simulate_failure,
                               "lost_devices": lost, **rplan.to_dict()}
        print(json.dumps(out))
        return out

    args.run_id = uuid.uuid4().hex
    run = _run_state(args, 0)
    rec, metrics, sup = run["rec"], run["metrics"], run["sup"]
    t_run = time.time()
    sharded = n_dev > 1
    ranks: Dict[int, Dict] = {}
    losses, aux, mtp_ce, gnorm, step_times = {}, {}, {}, {}, []
    recovery, backend = None, None
    strategy, axes, devices_now = args.strategy, dict(mesh), n_dev
    seg = {"strategy": strategy, "stop": args.steps, "fail_at": args.simulate_failure}

    def run_segment(pool, seg, path, axes):
        if rec.enabled:
            seg["comm_terms"] = _comm_byte_terms(cfg, args, seg["strategy"], axes,
                                                 mesh_size(axes))
        if pool is None:
            return [train_rank(RankContext(0, 1, device), cfg, tcfg, args, path, seg)]
        return pool.run(train_rank, cfg, tcfg, args, path, seg, mesh=axes)

    with (contextlib.nullcontext(pool if sharded else None)
          if pool is not None or not sharded
          else Pool(world=mesh_size(mesh), device=device)) as pool:
        backend = None if pool is None else pool.backend
        results = run_segment(pool, seg, path, axes)
        while True:
            for r in results:
                _merge_rank(ranks, r)
            r0 = results[0]
            for acc, key in ((losses, "losses"), (aux, "aux"), (mtp_ce, "mtp_ce"),
                             (gnorm, "grad_norm")):
                acc.update(r0[key])
            step_times += r0["step_s"]
            if recovery is not None and "first_step_s" not in recovery:
                recovery["restore_s"] = round(r0.get("restore_s", 0.0), 4)
                recovery["restored_step"] = r0["restored"]["step"]
                recovery["steps_replayed"] = recovery["at_step"] - r0["restored"]["step"]
                recovery["reinit_leaves"] = r0["restored"]["reinit_leaves"]
                recovery["restore_mode"] = r0["restored"]["mode"]
                recovery["first_step_s"] = round(r0.get("first_step_s", 0.0), 4)
                recovery["recovery_s"] = round(
                    recovery["plan_s"] + recovery["compile_s"] + recovery["restore_s"]
                    + recovery["first_step_s"], 4)
                print(f"recovered: resumed from step {recovery['restored_step']} on "
                      f"mesh {tuple(axes.values())} strategy {strategy} (plan "
                      f"{recovery['plan_s'] * 1e3:.0f}ms, compile "
                      f"{recovery['compile_s'] * 1e3:.0f}ms, restore "
                      f"{recovery['restore_s'] * 1e3:.0f}ms, {recovery['restore_mode']})",
                      flush=True)
                if rec.enabled:
                    record_recovery(metrics, recovery)
            stopped = r0["stopped"]
            if stopped is None:
                break
            if stopped[0] == "die":
                print(f"fault injection: dying at step {stopped[1]}", flush=True)
                if pool is not None:
                    pool.close()
                os._exit(42)
            # ---- simulated loss of ranks: re-plan, restore cut for them, resume
            at = stopped[1]
            lost = args.fail_devices or devices_now // 2
            rec.event("failure", step=int(at), lost_devices=int(lost))
            n_surv = survivors(devices_now, lost)
            prog, compile_s = None, 0.0
            if run["precomp"] is not None:
                # the exposed wait for the background build (0 once it landed)
                with rec.span("recovery/compile", category="recovery", step_num=at):
                    t_c = time.perf_counter()
                    prog = run["precomp"].get(n_surv, block=args.precompile_block,
                                              timeout=600.0)
                    compile_s = time.perf_counter() - t_c
            with rec.span("recovery/plan", category="recovery", step_num=at):
                t0 = time.perf_counter()
                if prog is not None:
                    rplan = prog.plan      # the plan the build was made for
                else:
                    compute_ref = None
                    if step_times:
                        h = sorted(step_times)
                        compute_ref = (h[len(h) // 2], n_batch_shards(axes))
                    rplan = plan_recovery(
                        cfg, n_surv, batch=args.batch, seq=args.seq,
                        optimizer=args.optimizer, compression=args.compression,
                        strategy=(None if args.recover_strategy == "auto"
                                  else args.recover_strategy),
                        compute_ref=compute_ref)
                plan_s = time.perf_counter() - t0
            before = {"mesh": list(axes.values()), "strategy": strategy,
                      "devices": devices_now}
            devices_now, strategy, axes = rplan.n_devices, rplan.strategy, rplan.axes()
            if prog is not None:
                path, path_reason = prog.bundle[1], "precompiled"
            else:
                ns = argparse.Namespace(**vars(args))
                ns.strategy = strategy
                path, path_reason = _pick_mode(ns, tcfg, axes, devices_now)
            print(f"failure at step {at}: lost {lost} devices; recovery plan: "
                  f"{rplan.reason}; path={path} ({path_reason})", flush=True)
            recovery = {"at_step": at, "lost_devices": lost, "before": before,
                        "after": {"mesh": list(rplan.mesh_shape), "strategy": strategy,
                                  "devices": devices_now},
                        "reason": rplan.reason, "restored_step": None,
                        "steps_replayed": None, "reinit_leaves": [],
                        "precompiled": prog is not None, "restore_mode": None,
                        "plan_s": round(plan_s, 4), "compile_s": round(compile_s, 4)}
            run["monitor"] = type(run["monitor"])(
                type(run["monitor"].detector)(tolerance=args.straggler_tol),
                metrics=metrics, recorder=rec)
            seg = {"strategy": strategy, "stop": args.steps, "start": at,
                   "phase": "recovery/first_step",
                   "recovery": {"t1": time.perf_counter()},
                   "prog": prog is not None, "n_survivors": n_surv}
            if run["ckpt"].latest_step() is None:
                raise SystemExit(f"--simulate-failure {args.simulate_failure}: no "
                                 f"checkpoint to recover from (set --ckpt-every <= "
                                 f"the failure step)")
            results = run_segment(pool if devices_now > 1 else None, seg, path, axes)

    order = sorted(losses)
    loss_list = [losses[s] for s in order]
    steady = step_times[1:] or step_times
    step_ms = statistics.median(steady) * 1e3 if steady else None
    out = {"arch": cfg.name, "steps": args.steps,
           "first_loss": loss_list[0] if loss_list else None,
           "final_loss": float(np.mean(loss_list[-10:])) if loss_list else None,
           "wall_s": round(time.time() - t_run, 1),
           "losses": loss_list,
           "strategy": strategy, "mesh": list(axes.values()) if sharded or recovery
           else list(plan.mesh_shape),
           "straggler_flags": run["monitor"].flags,
           "path": path, "path_reason": path_reason,
           "device": device_name(device),
           "step_ms": step_ms,
           "tokens_per_s": (args.batch * args.seq / (step_ms / 1e3) if step_ms else None),
           "param_count": cfg.param_count(),
           "tree_params": tree_size(param_shapes(cfg)),
           "aux": [aux[s] for s in order], "grad_norm": [gnorm[s] for s in order],
           **planned}
    if mtp_ce:
        out["mtp_ce"] = [mtp_ce[s] for s in sorted(mtp_ce)]
    if sharded:
        out["pool"] = {"ranks": mesh_size(mesh), "backend": backend,
                       "cards": 1 if device.type == "cuda" else 0}
        out["ranks"] = [{**{k: v for k, v in a.items() if k != "trace"},
                         "regions_ms": {k: statistics.median(v[1:] or v)
                                        for k, v in a["regions_ms"].items()}}
                        for _, a in sorted(ranks.items())]
    out["supervisor"] = {"retries": sup.retries,
                         "proactive_checkpoints": sup.proactive_checkpoints}
    if run["precomp"] is not None:
        out["supervisor"]["precompile"] = run["precomp"].stats()
    if run["writes"]:
        out["checkpoints"] = run["writes"]
    if recovery is not None:
        out["recovery"] = recovery
    if rec.enabled:
        os.makedirs(args.trace_dir, exist_ok=True)
        meta = {"arch": cfg.name, "strategy": strategy, "path": path,
                "devices": devices_now, "batch": args.batch, "seq": args.seq,
                "sync_policy": args.trace_sync, "ranks": len(ranks),
                "spans_of_rank": 0, "chrome_pid": "rank" if sharded else 1}
        write_jsonl(os.path.join(args.trace_dir, "trace.jsonl"), rec,
                    metrics=metrics.to_dict(), meta=meta)
        chrome = os.path.join(args.trace_dir, "trace_chrome.json")
        if sharded:
            write_chrome_trace_ranks(chrome, {k: (rec if k == 0 else a["trace"])
                                              for k, a in ranks.items()})
        else:
            write_chrome_trace(chrome, rec)
        out["trace"] = {"dir": args.trace_dir, "spans": len(rec.spans),
                        "events": len(rec.events)}
        out["metrics"] = metrics.to_dict()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
