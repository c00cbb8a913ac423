"""Multi-pod dry-run: trace every (arch × shape) cell on the production
meshes and extract memory, cost and collective analyses
(``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh pod --out cell.json        # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --outdir benchmarks/dryrun_results_torch           # every cell

The reference lowers and compiles the 256- or 512-device SPMD program on
host placeholders. The port has no SPMD compiler: its programs are one
manual program per rank (``train.step.make_gspmd_train_step``,
``train.serve``). So a cell here is rank 0's program of the production mesh,
run once with no memory and no peer ranks:

* a ``torch.distributed`` world of 256 or 512 ranks on the ``"fake"``
  backend (``FakeStore``), whose collectives return at once with the right
  shapes; the mesh makes only the process groups rank 0 asks for
  (``dist.sharding.LazyGroups``);
* every tensor fake (``FakeTensorMode``) on ``--device`` (the card by
  default), so the flash attention and SSD custom ops take their
  ``register_fake`` and nothing is allocated (deepseek-v3-671b's state is
  ~1.3 TB of bf16);
* the ops it dispatches counted by ``perf.op_analysis.trace_costs``, the
  terms by ``perf.roofline``.

A row keeps the reference's keys, so either package's predictor reads
either's rows: ``lower_s`` is the time to build and trace the cell,
``compile_s`` is 0.0, ``memory`` holds the rank's argument bytes (its state
slices, batch rows, resident weights and caches), the peak of the bytes its
step's temporaries held at once (``temp_size_in_bytes``) and its outputs
(``alias_size_in_bytes`` those that are arguments updated in place), and
``xla_flops_per_module`` the counted flops. The process group is global, so
``--all`` traces each cell in a process of its own, as the reference
compiles each in its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, TrainConfig,
                                 cell_is_runnable, get_config, get_shape)
from repro_torch.dist.sharding import Mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.perf.op_analysis import trace_costs
from repro_torch.perf.roofline import model_flops_for, roofline_from_trace

DEFAULT_OUTDIR = "benchmarks/dryrun_results_torch"


def fake_world(size: int) -> None:
    """A ``torch.distributed`` world of ``size`` ranks on the ``"fake"``
    backend with this process as rank 0 (the one made before is destroyed
    if its size differs). A world of one rank needs none: its mesh's groups
    are all ``None``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    if size > 1:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def trace_cell(cfg, shape, mesh: Mesh, tcfg: TrainConfig, strategy: str = "fsdp_tp",
               device="cuda"):
    """(row fields, ``CellProgram``, ``CompStats``) of rank ``mesh.rank``'s
    program of one cell, traced once on fake tensors; the world of
    ``mesh.size`` ranks must exist (``fake_world``)."""
    from repro_torch.tree import tree_leaves
    t0 = time.time()
    prog = input_specs(cfg, shape, mesh, tcfg, strategy, device=device)
    with prog.fake_mode, trace_costs() as stats:
        out = prog.fn(*prog.args)
    t_trace = time.time() - t0
    arg_ids = {id(t.untyped_storage()) for t in tree_leaves(prog.args)
               if isinstance(t, torch.Tensor)}
    outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
    step = 4 if prog.kind == "train" else 0     # the reference's int32 step count
    mem = {"temp_size_in_bytes": int(stats.peak_bytes),
           "argument_size_in_bytes": int(prog.arg_bytes),
           "output_size_in_bytes": int(sum(outs.values()) + step),
           "alias_size_in_bytes": int(sum(n for k, n in outs.items() if k in arg_ids)
                                      + step),
           "generated_code_size_in_bytes": 0}
    rf = roofline_from_trace(stats, mesh.size, model_flops=model_flops_for(cfg, shape))
    fields = dict(
        n_chips=mesh.size,
        lower_s=round(t_trace, 2), compile_s=0.0,
        memory=mem,
        bytes_per_device=mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"],
        collective_counts={k: float(v) for k, v in stats.coll_counts.items()},
        xla_flops_per_module=float(stats.flops),
        roofline=rf.to_dict(),
    )
    return fields, prog, stats


def run_cell(arch: str, shape_id: str, mesh_kind: str = "pod",
             strategy: str = "fsdp_tp", optimizer: str = "adamw",
             remat: str = "full", verbose: bool = True,
             ce_impl: str = "gather", attn_block: int = 0,
             microbatches: int = 1, device="cuda") -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_id)
    ok, why = cell_is_runnable(cfg, shape)
    row: dict = {"arch": arch, "shape": shape_id, "mesh": mesh_kind,
                 "strategy": strategy, "ce_impl": ce_impl,
                 "attn_block": attn_block, "remat": remat,
                 "optimizer": optimizer, "microbatches": microbatches}
    if not ok:
        row.update(status="SKIP", reason=why)
        return row
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card (torch.cuda.is_available() "
                           "is false); pass --device cpu to trace on the CPU")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    fake_world(mesh.size)
    tcfg = TrainConfig(optimizer=optimizer, remat_policy=remat, ce_impl=ce_impl)
    if attn_block:
        cfg = dataclasses.replace(cfg, attn_block=attn_block)
    if microbatches > 1:
        shape = dataclasses.replace(shape, microbatches=microbatches)
    fields, _, _ = trace_cell(cfg, shape, mesh, tcfg, strategy, device=device)
    row.update(status="OK", **fields)
    if verbose:
        print(json.dumps(row, indent=1))
    return row


# ---------------------------------------------------------------------------
# Orchestrator: all cells × meshes in subprocesses
# ---------------------------------------------------------------------------

def _cell_cmd(arch, shape_id, mesh_kind, outfile, strategy, optimizer, remat, device):
    return [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", arch, "--shape", shape_id, "--mesh", mesh_kind,
            "--strategy", strategy, "--optimizer", optimizer,
            "--remat", remat, "--device", str(device), "--out", outfile]


def run_all(outdir: str, meshes=("pod", "multipod"), archs=None, shapes=None,
            strategy="fsdp_tp", optimizer="adamw", remat="full",
            timeout=3600, device="cuda") -> list:
    import pathlib
    outp = pathlib.Path(outdir)
    outp.mkdir(parents=True, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                                         if p)}
    rows = []
    for mesh_kind in meshes:
        for arch in (archs or ARCH_IDS):
            for shape in (shapes or [s.name for s in ALL_SHAPES]):
                cfg = get_config(arch)
                sh = get_shape(shape)
                name = f"{arch}_{shape}_{mesh_kind}".replace("/", "_")
                outfile = str(outp / f"{name}.json")
                ok, why = cell_is_runnable(cfg, sh)
                if not ok:
                    row = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "SKIP", "reason": why}
                    with open(outfile, "w") as f:
                        json.dump(row, f, indent=1)
                    rows.append(row)
                    print(f"[skip] {name}: {why}", flush=True)
                    continue
                if os.path.exists(outfile):
                    with open(outfile) as f:
                        row = json.load(f)
                    if row.get("status") == "OK":
                        rows.append(row)
                        print(f"[cached] {name}", flush=True)
                        continue
                t0 = time.time()
                proc = subprocess.run(
                    _cell_cmd(arch, shape, mesh_kind, outfile, strategy,
                              optimizer, remat, device),
                    capture_output=True, text=True, timeout=timeout, env=env)
                if proc.returncode == 0 and os.path.exists(outfile):
                    with open(outfile) as f:
                        row = json.load(f)
                    print(f"[ok] {name} ({time.time()-t0:.0f}s) "
                          f"bottleneck={row.get('roofline', {}).get('bottleneck')}",
                          flush=True)
                else:
                    row = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "FAIL",
                           "error": proc.stderr[-2000:]}
                    with open(outfile, "w") as f:
                        json.dump(row, f, indent=1)
                    print(f"[FAIL] {name}:\n{proc.stderr[-800:]}", flush=True)
                rows.append(row)
    with open(outp / "summary.json", "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--strategy", default="fsdp_tp")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--ce-impl", default="gather")
    ap.add_argument("--attn-block", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--outdir", default=DEFAULT_OUTDIR)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda: the custom ops' fakes)")
    return ap


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.all:
        run_all(args.outdir, meshes=tuple(args.meshes.split(",")),
                strategy=args.strategy, optimizer=args.optimizer,
                remat=args.remat, device=args.device)
        return
    if not (args.arch and args.shape):
        build_parser().error("give --arch and --shape, or --all")
    try:
        row = run_cell(args.arch, args.shape, args.mesh, args.strategy,
                       args.optimizer, args.remat, ce_impl=args.ce_impl,
                       attn_block=args.attn_block,
                       microbatches=args.microbatches, device=args.device)
    except Exception:
        row = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "FAIL", "error": traceback.format_exc()}
        print(row["error"], file=sys.stderr)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(row, f, indent=1)
        sys.exit(1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)


if __name__ == "__main__":
    main()
