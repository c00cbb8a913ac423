"""Pool jobs (``dist.pool.Pool.run``) that run the compressed collectives
and the sharded LeNet iteration on inputs the caller gives and return what
each rank holds, as numpy arrays, with the rank's codec-kernel launches.
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


def reset_launches(ctx=None) -> None:
    """Zero this rank's launch counters (a job, or called in place)."""
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


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
