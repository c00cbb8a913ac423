"""Single-device training entry point, on a CUDA device unless ``--device
cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --batch 8 --seq 512 --steps 8 --compression int8_ef

Weights are the port's own seeded random init, drawn on the device; the
batches are the reference's deterministic step-indexed tokens (and stub
frames for an encoder-decoder). The step updates the parameters, moments
and residuals in place, as the reference's jitted step donates its state.
``--remat`` is the block remat policy: none, full, or dots (the dense
products' outputs kept). The last
stdout line is the report JSON, with the keys of ``repro.launch.train``'s
report that a single-device run has (``arch steps first_loss final_loss
wall_s losses strategy mesh``) plus ``device``, ``step_ms`` (median over the
steps after the first, each timed on the host clock ending in a
synchronise), ``tokens_per_s`` (batch × seq over that median),
``param_count`` and ``tree_params`` (the config's count and the weights'
own, which differ for a hybrid), and per step the MoE ``aux`` loss and,
with an MTP head, ``mtp_ce``.
Checkpointing, fault tolerance, sharding and tracing are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np


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
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--dtype", default="",
                    help="override model compute/param dtype (e.g. float32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the execution plan as JSON and exit")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import device_name, sync
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_size

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype, param_dtype=args.dtype)
    tcfg = TrainConfig(learning_rate=args.lr, optimizer=args.optimizer,
                       total_steps=args.steps, warmup_steps=args.steps // 10,
                       remat_policy=args.remat,
                       grad_compression=args.compression, seed=args.seed)
    device = resolve_device(args.device)
    print(f"device={device} ({device_name(device)}) arch={cfg.name} "
          f"params={cfg.param_count()} path=single "
          f"(single device; sharded steps not ported yet)", flush=True)
    if args.dry_run:
        out = {"dry_run": True, "arch": cfg.name, "device": str(device),
               "devices": 1, "mesh": [1, 1], "strategy": None,
               "compression": args.compression, "optimizer": args.optimizer,
               "path": "single", "steps": args.steps, "batch": args.batch,
               "seq": args.seq}
        print(json.dumps(out))
        return out

    state = init_train_state(cfg, tcfg, seed=args.seed, device=device)
    n_tree = tree_size(state.params)
    step_fn = make_train_step(cfg, tcfg, microbatches=args.microbatches)
    losses, step_times, aux, mtp_ce = [], [], [], []
    t_run = time.time()
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
           "strategy": None, "mesh": [1, 1],
           "device": device_name(device),
           "step_ms": step_ms,
           "tokens_per_s": (args.batch * args.seq / (step_ms / 1e3)
                            if step_ms else None),
           "param_count": cfg.param_count(), "tree_params": n_tree,
           "aux": aux}
    if mtp_ce:
        out["mtp_ce"] = mtp_ce
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
