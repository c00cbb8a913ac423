"""Smoke for the comm/compute-overlap train step: partition and speed
(``tools/overlap_smoke.py``).

  PYTHONPATH=src python -m repro_torch.tools.overlap_smoke [--device cuda]

On a world of 8 ranks (``dist.pool.Pool``, gloo; all on the card under
``cuda``), builds the sharded LM train step for ``tp`` on the (data 1,
model 8) mesh twice, the legacy sequential body (``overlap=False``: gather
everything, then compute) and the partitioned body (``overlap=True``:
Megatron column/row-split products on local parameter slices), and asserts
the two claims the overlap work stands on:

  1. **The tp body shards activations over the model axis.** One eager
     step of each body under ``tp_probe_sink`` records, on rank 0, the
     local ``mlp_hidden`` shapes: the sequential body sees the full d_ff,
     the overlapped body exactly d_ff/8 on the same leading dims.
  2. **Overlapped ≤ sequential step time**, each the min of ``ITERS``
     steps after a warm-up, a step's time its slowest rank's. Both bodies
     run eagerly (``launch.overlap``: the port compiles only the overlap
     body). The
     legacy body computes the full batch with full parameters on every
     model rank; the partitioned body computes a 1/8 slice. Ranks sharing
     one card exchange through gloo's host copies, so this times those
     copies as much as the compute.

Exit code 0 = both hold. The last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

ARCH, STRATEGY = "smollm-360m", "tp"
B, S, ITERS = 8, 32, 5
POOL = 8


def probe_shapes(ctx, arch: str, strategy: str) -> dict:
    """Pool job: one eager step of each body from the same init under
    ``tp_probe_sink``; {"sequential"|"overlap": [(tag, shape), ...]} of this
    rank."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.launch.overlap import overlap_config
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.models.layers import tp_probe_sink
    from repro_torch.train.step import (init_sharded_train_state,
                                        make_sharded_train_step)

    mesh, dev = ctx.mesh, ctx.device
    cfg, tcfg = overlap_config(arch)
    batch = batch_shardings(make_batch_for(cfg, B, S, step=0), mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}
    out = {}
    for overlap in (False, True):
        state = init_sharded_train_state(cfg, tcfg, mesh, strategy, seed=0, device=dev)
        step = make_sharded_train_step(cfg, tcfg, mesh, strategy, overlap=overlap)
        with tp_probe_sink([]) as rec:
            step(state, batch)
        out["overlap" if overlap else "sequential"] = rec
    return out


def _by_tag(records):
    shapes = {}
    for tag, shape in records:
        shapes.setdefault(tag, set()).add(tuple(shape))
    return shapes


def claim_partition(pool, arch: str = ARCH, strategy: str = STRATEGY) -> dict:
    """Claim 1 on ``pool``: rank 0's local ``mlp_hidden`` shapes of the
    overlapped body are the sequential body's with d_ff cut m ways."""
    from repro_torch.perf.sweep import arch_mesh_axes
    axes = arch_mesh_axes(strategy, POOL)
    m = int(axes.get("model", 1))
    assert m > 1, f"tp mesh has no model axis: {axes}"
    rank0 = pool.run(probe_shapes, arch, strategy, mesh=axes)[0]
    seq_shapes, ov_shapes = _by_tag(rank0["sequential"]), _by_tag(rank0["overlap"])
    assert "mlp_hidden" in seq_shapes and "mlp_hidden" in ov_shapes, \
        {"seq": seq_shapes, "overlap": ov_shapes}
    for ls in ov_shapes["mlp_hidden"]:
        want = ls[:-1] + (ls[-1] * m,)
        assert want in seq_shapes["mlp_hidden"], {
            "local": ls, "expected_full": want,
            "sequential_saw": sorted(seq_shapes["mlp_hidden"])}
    return {"mesh": dict(axes), "model": m,
            "mlp_hidden_full": sorted(seq_shapes["mlp_hidden"]),
            "mlp_hidden_local": sorted(ov_shapes["mlp_hidden"])}


def claim_speed(pool, arch: str = ARCH, strategy: str = STRATEGY) -> dict:
    """Claim 2 on ``pool``: min of ``ITERS`` overlapped steps ≤ min
    of ``ITERS`` sequential ones."""
    from repro_torch.launch.overlap import slowest, time_bodies
    from repro_torch.perf.sweep import arch_mesh_axes
    per_rank = pool.run(time_bodies, arch, strategy, ITERS,
                        mesh=arch_mesh_axes(strategy, POOL))
    seq_ms = min(slowest(per_rank, "sequential")) * 1e3
    ov_ms = min(slowest(per_rank, "overlap")) * 1e3
    out = {"sequential_ms": seq_ms, "overlapped_ms": ov_ms, "ratio": ov_ms / seq_ms,
           "sequential_steps_ms": [t * 1e3 for t in slowest(per_rank, "sequential")],
           "overlapped_steps_ms": [t * 1e3 for t in slowest(per_rank, "overlap")]}
    print(f"  claim 2: {json.dumps(out)}", flush=True)
    assert ov_ms <= seq_ms, {
        "sequential_ms": seq_ms, "overlapped_ms": ov_ms,
        "note": "partitioned body must not be slower than the "
                "gather-everything body on the tp mesh"}
    return out


def main(argv=None, pool=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device (the card unless cpu)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool
    from repro_torch.launch.serve import device_name

    dev = resolve_device(args.device)
    t0 = time.time()
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=POOL, device=dev)) as p:
        part = claim_partition(p)
        speed = claim_speed(p)
    print(json.dumps({
        "ok": True, "arch": ARCH, "strategy": STRATEGY, "device": device_name(dev),
        **part, "sequential_ms": round(speed["sequential_ms"], 2),
        "overlapped_ms": round(speed["overlapped_ms"], 2),
        "ratio": round(speed["ratio"], 3), "wall_s": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
