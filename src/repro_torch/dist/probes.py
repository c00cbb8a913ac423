"""Pool jobs (``dist.pool.Pool.run``) that run the compressed collectives,
the sharded LeNet iteration and the sharded LM train step on inputs the
caller gives and return what each rank holds, as numpy arrays or numbers,
with the rank's kernel launches.
The parity tests and ``chip_smoke.py`` hold the results to a reference
computed in the caller's process; the jobs live here because a spawned rank
imports them by module path, and the port imports nothing else.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import quantize as Q
from repro_torch.kernels import ssd_scan as SSD

_COUNTERS = {"flash_attention": (FA, "LAUNCHES"),
             "quantize_absmax": (Q, "ABSMAX_LAUNCHES"),
             "quantize_int8": (Q, "QUANTIZE_LAUNCHES"),
             "dequantize_int8": (Q, "DEQUANTIZE_LAUNCHES"),
             "ssd_scan": (SSD, "LAUNCHES")}


def read_launches(ctx=None) -> Dict[str, int]:
    """This rank's launches of every port kernel since the last reset (a
    job, or called in place)."""
    return {k: getattr(mod, attr) for k, (mod, attr) in _COUNTERS.items()}


def launch_snapshot(ctx=None) -> Dict:
    """``read_launches`` with flash attention's and the SSD scan's launches
    by design ("flash_by_design", "ssd_by_design")."""
    return {**read_launches(), "flash_by_design": dict(FA.LAUNCHES_BY_VARIANT),
            "ssd_by_design": dict(SSD.LAUNCHES_BY_VARIANT)}


def read_designs(ctx=None) -> Dict[str, int]:
    """This rank's flash attention launches by design since the last reset."""
    return dict(FA.LAUNCHES_BY_VARIANT)


def reset_launches(ctx=None) -> None:
    """Zero this rank's launch counters, by design too (a job, or called in
    place)."""
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
    FA.LAUNCHES_BY_VARIANT = dict.fromkeys(FA.VARIANTS, 0)
    SSD.LAUNCHES_BY_VARIANT = dict.fromkeys(SSD.VARIANTS, 0)


def set_cudnn(ctx, enabled: bool) -> bool:
    """Turn cuDNN on or off on this rank; return whether it was on."""
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    return was


def collective(ctx, xs: np.ndarray, mode: str,
               errs: Optional[np.ndarray] = None) -> Dict:
    """One ``compressed_psum_mean`` (``mode`` none, bf16 or int8) or, with
    ``mode`` "int8_ef", one ``compressed_psum_mean_ef`` per step over the
    mesh's one axis. ``xs`` is ``[steps, ranks, ...]``: rank r reduces
    ``xs[s, r]`` at step s (int8_ef starts from ``errs[r]``, else zeros, and
    threads its residual). Returns the means (and residuals) per step and
    the codec launches of the call."""
    from repro_torch.dist.compression import (compressed_psum_mean,
                                              compressed_psum_mean_ef)
    mesh, dev = ctx.mesh, ctx.device
    group = mesh.group(mesh.axis_names)
    reset_launches()
    means, residuals = [], []
    err = None
    if mode == "int8_ef":
        err = (torch.zeros(xs.shape[2:]) if errs is None
               else torch.from_numpy(errs[mesh.rank])).to(dev)
    for step in range(xs.shape[0]):
        x = torch.from_numpy(xs[step, mesh.rank]).to(dev)
        if mode == "int8_ef":
            mean, err = compressed_psum_mean_ef(x, group, err)
            residuals.append(err.cpu().numpy())
        else:
            mean = compressed_psum_mean(x, group, mode)
        means.append(mean.cpu().numpy())
    return {"means": np.stack(means),
            "residuals": np.stack(residuals) if residuals else None,
            "launches": read_launches()}


def sharded_iteration(ctx, cfg, modes: List[str],
                      params: Dict[str, np.ndarray],
                      batch: Dict[str, np.ndarray]) -> Dict:
    """One sharded LeNet iteration (``perf.sweep.make_sharded_iteration``)
    from the full ``params`` (port layout) on the global ``batch``, in each
    execution mode of ``modes``, dropout draws from seed 0. Returns, per
    mode, the new params gathered to full, the loss, and the codec launches
    of the iteration (the compiled modes' warm-up call is the iteration)."""
    from repro_torch.dist.sharding import gather_to_full
    from repro_torch.perf.sweep import make_sharded_iteration, sharded_inputs
    mesh, dev = ctx.mesh, ctx.device
    full = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    out = {}
    for mode in modes:
        it, specs, batch_spec = make_sharded_iteration(cfg, mode, mesh, full)
        p, lb, rng = sharded_inputs(cfg, mesh, specs, batch_spec, full, b)
        reset_launches()
        new, loss = it(p, lb, rng)
        launches = read_launches()
        out[mode] = {"params": {k: gather_to_full(v, specs[k], mesh).cpu().numpy()
                                for k, v in new.items()},
                     "loss": float(loss), "launches": launches}
    return out


def _lm_rank_inputs(ctx, cfg, tcfg, strategy, seed, batch, params=None):
    """This rank's sharded TrainState from ``seed`` (or the whole
    ``params``) and its rows of the global ``batch`` (numpy), on its device."""
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.train.step import init_sharded_train_state
    mesh, dev = ctx.mesh, ctx.device
    state = init_sharded_train_state(cfg, tcfg, mesh, strategy, seed=seed,
                                     device=dev, params=params)
    rows = batch_shardings({k: torch.from_numpy(v) for k, v in batch.items()},
                           mesh)
    return state, {k: v.to(dev) for k, v in rows.items()}


def sharded_bodies(ctx, cfg, tcfg, strategy, seed: int,
                   batch: Dict[str, np.ndarray]) -> Dict:
    """One legacy and one overlap step of ``make_sharded_train_step`` from
    the same init (``seed``) on this rank's rows of ``batch``. With sgd, b1
    0, no decay and no clip, g = (p0 − p1)/lr is each body's reduced
    gradient; returns, per tensor of this rank's slices, max|g_legacy| and
    max|g_overlap − g_legacy|, and both bodies' losses."""
    from repro_torch.models import model as MD
    from repro_torch.train.step import make_sharded_train_step
    from repro_torch.tree import tree_leaves
    full = MD.init_model(cfg, seed=seed, device=ctx.device)
    grads, losses = {}, {}
    for overlap in (False, True):
        state, rows = _lm_rank_inputs(ctx, cfg, tcfg, strategy, seed, batch, full)
        p0 = [t.clone() for t in tree_leaves(state.params)]
        step = make_sharded_train_step(cfg, tcfg, ctx.mesh, strategy,
                                       overlap=overlap)
        state, metrics = step(state, rows)
        grads[overlap] = [(a.float() - b.float()) / metrics["lr"]
                          for a, b in zip(p0, tree_leaves(state.params))]
        losses[overlap] = float(metrics["loss"])
        del state, p0
    return {"gmax": [float(g.abs().max()) for g in grads[False]],
            "err": [float((a - b).abs().max())
                    for a, b in zip(grads[True], grads[False])],
            "loss": losses}


def sharded_modes(ctx, cfg, tcfg, strategy, seed: int,
                  batch: Dict[str, np.ndarray], mode: str, steps: int = 2
                  ) -> Dict:
    """``steps`` steps of the overlap body eager and compiled (``mode``
    jit or jit_donate), each from the same init (``seed``) on
    this rank's rows of ``batch``: per mode the losses and this rank's
    kernel launches per step (the compiled mode's after its warm-up step,
    the compile), the compiled mode's graph breaks and graphs, and the
    largest difference of the two modes' parameter slices after the last
    step."""
    from torch._dynamo.utils import counters

    from repro_torch.models import model as MD
    from repro_torch.train.step import make_sharded_train_step
    from repro_torch.tree import tree_leaves
    full = MD.init_model(cfg, seed=seed, device=ctx.device)
    out, params = {}, {}
    for m in ("eager", mode):
        torch.compiler.reset()
        counters.clear()
        state, rows = _lm_rank_inputs(ctx, cfg, tcfg, strategy, seed, batch,
                                      full)
        step = make_sharded_train_step(cfg, tcfg, ctx.mesh, strategy,
                                       overlap=True, mode=m)
        state, metrics = step(state, rows)                 # the compile
        losses = [float(metrics["loss"])]
        before = read_launches()
        for _ in range(steps - 1):
            state, metrics = step(state, rows)
            losses.append(float(metrics["loss"]))
        launches = {k: (v - before[k]) / max(steps - 1, 1)
                    for k, v in read_launches().items()}
        out[m] = {"losses": losses, "launches": launches,
                  "graph_breaks": sum(counters["graph_break"].values()),
                  "graphs": counters["stats"]["unique_graphs"]}
        params[m] = [t.detach().float().clone() for t in tree_leaves(state.params)]
        del state
    out["param_diff"] = max(float((a - b).abs().max())
                            for a, b in zip(params["eager"], params[mode]))
    return out


def sharded_train_profile(ctx, cfg, tcfg, strategy, seed: int,
                          batch: Dict[str, np.ndarray]) -> Dict:
    """A legacy sharded step on this rank, warmed up once, then traced by
    ``torch.profiler``: the rank's wall ms under the profiler (host clock),
    its device busy ms (the union of its kernels' intervals in the trace;
    None if the trace holds no kernel) and its kernel count for the step."""
    import json
    import os
    import tempfile
    import time
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.step import make_sharded_train_step
    state, rows = _lm_rank_inputs(ctx, cfg, tcfg, strategy, seed, batch)
    step = make_sharded_train_step(cfg, tcfg, ctx.mesh, strategy)
    sync = (lambda: torch.cuda.synchronize(ctx.device)
            if ctx.device.type == "cuda" else None)
    state, _ = step(state, rows)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, rows)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    busy, end = 0.0, float("-inf")
    for e in kernels:                      # union of the kernels' intervals
        s, t = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3 if kernels else None,
            "kernels": len(kernels)}


def release_memory(ctx) -> int:
    """Return this rank's cached device memory to the driver (a pool that
    hosts one job after another on a shared card); the bytes still
    reserved."""
    import gc
    gc.collect()
    if ctx.device.type != "cuda":
        return 0
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(ctx.device)
