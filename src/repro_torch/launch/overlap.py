"""Comm/compute overlap benchmark: the sequential against the overlapped
sharded train step body (``benchmarks/overlap.py``).

  PYTHONPATH=src python -m repro_torch.launch.overlap [--out OVERLAP.md]

For each architecture family × tp-family strategy, on a world of 8 ranks
(``dist.pool.Pool``, gloo; all ranks share the card under ``cuda``), times
the sharded train step (``make_sharded_train_step``) under the legacy body
(whole-tree gathers, ``overlap=False``) and the partitioned/streamed body
(``overlap=True``: Megatron-split tp compute on local slices, per-layer
fsdp gathers), and prices the step's collectives under the loaded
calibration (``perf.predict.estimate_comm``): serialized, and with the
fitted per-strategy overlap factor ρ applied (``exposed = max(0, comm −
ρ·compute)``).

The reference times both bodies under ``jax.jit``. The port compiles only
the overlap body (``mode="jit"``; the legacy body is eager only), so both
bodies run eagerly here and the ratio compares like with like.

A step's time is its slowest rank's; each point reports the median of
``ITERS`` steps after a warm-up, each step started at a
barrier of the ranks. Ranks that share one card exchange through gloo's
host copies, so the wall-clock columns bound regression and measure no
link; the overlap pricing lives in the ρ column. The report is written
only to ``--out``; the last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time

import torch

ARCHS = ("smollm-360m", "mamba2-370m", "llama4-scout-17b-a16e")
STRATEGIES = ("fsdp", "tp", "fsdp_tp")
B, S, ITERS = 8, 32, 5
POOL = 8


def overlap_config(arch: str):
    """(model config, train config) of a point: the reduced arch in fp32,
    sgd with no momentum, clip, warm-up, remat or codec."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              param_dtype="float32")
    tcfg = TrainConfig(optimizer="sgd", beta1=0.0, grad_clip=1e9, total_steps=10,
                       warmup_steps=0, remat_policy="none", grad_compression="none")
    return cfg, tcfg


def time_bodies(ctx, arch: str, strategy: str, iters: int = ITERS) -> dict:
    """Pool job: this rank's seconds of the warm-up step and of
    ``iters`` steps of each body (``overlap`` False, then True) from the same
    init, each step started at a barrier of the mesh's ranks and ended by a
    synchronise of the device."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.train.step import (init_sharded_train_state,
                                        make_sharded_train_step)

    mesh, dev = ctx.mesh, ctx.device
    cfg, tcfg = overlap_config(arch)
    batch = batch_shardings(make_batch_for(cfg, B, S, step=0), mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}
    every = mesh.group(mesh.axis_names)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    for overlap in (False, True):
        state = init_sharded_train_state(cfg, tcfg, mesh, strategy, seed=0, device=dev)
        step = make_sharded_train_step(cfg, tcfg, mesh, strategy, overlap=overlap)
        sync()
        t0 = time.perf_counter()
        state, _ = step(state, batch)             # warm-up
        sync()
        warmup, times = time.perf_counter() - t0, []
        for _ in range(iters):
            if every is not None:
                torch.distributed.barrier(group=every)
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            sync()
            times.append(time.perf_counter() - t0)
        out["overlap" if overlap else "sequential"] = {"times": times,
                                                      "warmup_s": warmup}
        del state, step
    return out


def slowest(per_rank, body: str):
    """Each step's time over the ranks: its slowest rank's."""
    n = len(per_rank[0][body]["times"])
    return [max(r[body]["times"][i] for r in per_rank) for i in range(n)]


def run_point(pool, arch: str, strategy: str, calibration):
    from repro_torch.perf.planner.space import model_comm_sizes
    from repro_torch.perf.predict import estimate_comm
    from repro_torch.perf.sweep import arch_mesh_axes

    cfg, _ = overlap_config(arch)
    axes = arch_mesh_axes(strategy, POOL)
    per_rank = pool.run(time_bodies, arch, strategy, ITERS, mesh=axes)
    seq_ms = statistics.median(slowest(per_rank, "sequential")) * 1e3
    ov_ms = statistics.median(slowest(per_rank, "overlap")) * 1e3
    pb, ab = model_comm_sizes(cfg, B, S)
    comm = estimate_comm(strategy, POOL, pb, wire_bits=32, act_bytes=ab,
                         compute_seconds=ov_ms * 1e-3, calibration=calibration)
    return {"arch": arch, "strategy": strategy, "mesh": dict(axes),
            "seq_ms": seq_ms, "overlap_ms": ov_ms,
            "ratio": ov_ms / seq_ms,
            "comm_ms": comm.seconds * 1e3, "rho": comm.overlap,
            "exposed_ms": comm.exposed * 1e3,
            "calibration": comm.calibration_label,
            "warmup_s": {b: max(r[b]["warmup_s"] for r in per_rank)
                          for b in ("sequential", "overlap")}}


def render_md(rows, wall_s: float, device: str) -> str:
    cal = rows[0]["calibration"] if rows else "default"
    lines = [
        "# Comm/compute overlap: sequential vs partitioned/streamed body",
        "",
        "Generated by `PYTHONPATH=src python -m repro_torch.launch.overlap` on "
        f"a world of {POOL} gloo ranks on {device} (reduced fp32 configs, batch "
        f"{B}, seq {S}, median of {ITERS} eager steps after a warm-up, each its "
        "slowest rank's).",
        "",
        "**sequential** is the legacy body (eager whole-tree parameter "
        "gathers, then compute); **overlapped** is the partitioned body "
        "(`make_sharded_train_step(..., overlap=True)`: Megatron column/row-"
        "split tp compute on local slices, fsdp gathers streamed per layer). "
        "Ranks that share a card exchange through gloo's host copies, so the "
        "wall-clock columns bound regression and measure no link; the overlap "
        "*pricing* is the ρ column, the fitted per-strategy factor the cost "
        "model hides comm behind compute with (`exposed = max(0, comm − "
        f"ρ·compute)`), from the `{cal}` calibration.",
        "",
        "| arch | strategy | mesh | sequential ms | overlapped ms | "
        "ratio | comm ms | ρ | exposed ms |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        mesh = "×".join(f"{a}:{s}" for a, s in r["mesh"].items())
        lines.append(
            f"| {r['arch']} | {r['strategy']} | {mesh} | "
            f"{r['seq_ms']:.1f} | {r['overlap_ms']:.1f} | "
            f"{r['ratio']:.2f} | {r['comm_ms']:.2f} | {r['rho']:.2f} | "
            f"{r['exposed_ms']:.2f} |")
    lines += [
        "",
        f"Total wall time: {wall_s:.1f}s. dp is omitted: it has no parameter "
        "gathers to stream and no model axis to partition, so both bodies are "
        "the same program.",
        "",
    ]
    return "\n".join(lines)


def main(argv=None, pool=None):
    """Run the 9 points; ``pool``, when given, is an open ``Pool`` of at
    least 8 ranks (else one of 8 is opened on ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="write the markdown report here")
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device (the card unless cpu)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool
    from repro_torch.launch.serve import device_name
    from repro_torch.perf.costmodel import load_calibration

    dev = resolve_device(args.device)
    cal = load_calibration()
    t0 = time.time()
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=POOL, device=dev)) as p:
        rows = []
        for a in ARCHS:
            for s in STRATEGIES:
                rows.append(run_point(p, a, s, cal))
                r = rows[-1]
                print(f"  {a:24s} {s:8s} sequential {r['seq_ms']:9.3f} ms  overlapped "
                      f"{r['overlap_ms']:9.3f} ms  ratio {r['ratio']:.3f}  warm-up "
                      f"{r['warmup_s']}", flush=True)
    wall = time.time() - t0
    # regression bound, not a perf claim: the overlapped body must not
    # be materially slower than the sequential one on any point
    slow = [r for r in rows if r["ratio"] > 1.5]
    if slow:
        raise AssertionError(f"overlapped body >1.5x sequential: {slow}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(render_md(rows, wall, device_name(dev)))
        print(f"wrote {args.out}")
    print(json.dumps({"ok": True, "points": len(rows), "device": device_name(dev),
                      "worst_ratio": max(r["ratio"] for r in rows),
                      "rows": rows, "wall_s": round(wall, 1)}))
    return rows


if __name__ == "__main__":
    main()
