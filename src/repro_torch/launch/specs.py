"""Placement specs of the sharded programs (``repro.launch.specs``): the
batch's rows (``batch_shardings``), the decode caches by role
(``_batch_entry``, ``_cache_pspec``, ``cache_specs``), the parameters
(``params_only_shardings``) and the train state (``state_shardings``).

A spec is a tuple with one entry per dim, the reference's
``PartitionSpec`` (``dist.sharding``); the reference wraps each in a
``NamedSharding`` on its mesh, the port hands the tuples to
``dist.sharding.shard_of_full`` / ``gather_to_full`` on a ``Mesh`` of
process groups. Spec trees have tuple leaves: walk them driven by the
tensor tree they describe. ``mesh`` may be a ``Mesh`` or a plain ``{axis:
size}`` mapping.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.dist.sharding import (Mesh, axis_sizes, batch_pspec,
                                       logical_to_pspec, param_pspecs,
                                       resolve_strategy, shard_of_full)


def batch_shardings(batch: Dict[str, torch.Tensor],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of each leaf of a global batch: dim 0 split over the
    mesh's batch axes where it divides (``batch_pspec``), replicated over
    the others (views)."""
    return {k: shard_of_full(x, batch_pspec(mesh, x.ndim, int(x.shape[0])),
                             mesh)
            for k, x in batch.items()}


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def _batch_entry(mesh, B: int):
    """Greedy divisibility-aware batch entry: the rule ``batch_pspec``
    applies to the tokens, so caches and tokens agree on the batch split."""
    spec = batch_pspec(mesh, 1, int(B))
    return spec[0] if len(spec) else None


def _cache_pspec(role: str, shape, mesh) -> tuple:
    """The reference's role-aware spec of one cache leaf, dims addressed
    from the right: batch over the batch axes (else a ring's capacity over
    data), kv heads over model (else the head dim), MLA's latent rank over
    model, a Mamba2 conv state's channels and SSD state's heads over model;
    "pos" replicated."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    entries = [None] * nd
    model_ok = "model" in sizes
    msz = sizes.get("model", 1)

    def set_from_right(i, value):
        entries[nd - i] = value

    if role == "kv":                          # [..., B, cap, kvh, hd]
        B, cap, kvh, hd = shape[-4], shape[-3], shape[-2], shape[-1]
        be = _batch_entry(sizes, B)
        if be is not None:
            set_from_right(4, be)
        elif "data" in sizes and cap % sizes["data"] == 0:
            set_from_right(3, "data")
        if model_ok and kvh % msz == 0:
            set_from_right(2, "model")
        elif model_ok and hd % msz == 0:
            set_from_right(1, "model")
    elif role in ("lat", "rope"):             # [..., B, cap, r]
        B, cap, r = shape[-3], shape[-2], shape[-1]
        be = _batch_entry(sizes, B)
        if be is not None:
            set_from_right(3, be)
        elif "data" in sizes and cap % sizes["data"] == 0:
            set_from_right(2, "data")
        if role == "lat" and model_ok and r % msz == 0:
            set_from_right(1, "model")
    elif role == "conv":                      # [..., B, K-1, conv_dim]
        B, cdim = shape[-3], shape[-1]
        be = _batch_entry(sizes, B)
        if be is not None:
            set_from_right(3, be)
        if model_ok and cdim % msz == 0:
            set_from_right(1, "model")
    elif role == "ssd":                       # [..., B, H, Pd, N]
        B, H = shape[-4], shape[-3]
        be = _batch_entry(sizes, B)
        if be is not None:
            set_from_right(4, be)
        if model_ok and H % msz == 0:
            set_from_right(3, "model")
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def cache_specs(cfg, B: int, cap: int, mesh, dtype=torch.bfloat16):
    """(structs, specs) of the decode caches: shape-only tensors (the meta
    device) and, leaf for leaf, each one's ``_cache_pspec``."""
    from repro_torch.models.model import build_decode_caches
    structs = build_decode_caches(
        cfg, B, cap, dtype,
        mk=lambda shape, dt, role: torch.empty(shape, dtype=dt, device="meta"))
    specs = build_decode_caches(
        cfg, B, cap, dtype, mk=lambda shape, dt, role: _cache_pspec(role, shape, mesh))
    return structs, specs


# ---------------------------------------------------------------------------
# Parameter and state specs
# ---------------------------------------------------------------------------

def params_only_shardings(params, mesh, strategy):
    """The parameters' specs under ``strategy`` (``param_pspecs``)."""
    return param_pspecs(params, mesh, strategy)


def adafactor_nu_specs(params, mesh, strategy):
    """Specs of adafactor's factored moments (``optim.adafactor_init``'s
    list, one tuple per reference leaf in the reference's stacked layout):
    the row moment takes the leaf's logical axes but the last, the column
    moment all but the second to last, each resolved on its own shape as
    the reference's ``param_pspecs`` resolves the moments' ``Param`` axes;
    a stacking dim is "layers", which no strategy shards."""
    from repro_torch.models.model import param_axes
    from repro_torch.tree import (reference_leaves, stack_dims, tree_leaves,
                                  tree_map)
    strat = resolve_strategy(strategy)
    leaves = tree_leaves(params)
    axes = []
    tree_map(lambda p, ax: axes.append(ax), params, param_axes(params))
    out = []
    for path, idx in reference_leaves(params):
        dims = stack_dims(params, path)
        p, ax = leaves[idx[0]], axes[idx[0]]
        shape = tuple(p.shape[::-1] if ax.transposed else p.shape)
        names = ("layers",) * len(dims) + tuple(ax.names)
        shape = tuple(dims) + shape
        if len(shape) >= 2:
            out.append((logical_to_pspec(names[:-1], mesh, strat, shape[:-1]),
                        logical_to_pspec(names[:-2] + names[-1:], mesh, strat,
                                         shape[:-2] + shape[-1:])))
        else:
            out.append((logical_to_pspec(names, mesh, strat, shape),))
    return out


def state_shardings(state, mesh, strategy):
    """A TrainState of specs for the state of the single-device step
    (``train.step.init_train_state``), as the reference's GSPMD step places
    it: parameters, AdamW's and SGD's moments and the int8_ef residual by
    the parameters' logical rules, adafactor's factored moments by
    ``adafactor_nu_specs``; the step count (a host integer) ()."""
    from repro_torch.optim.optimizers import OptState
    from repro_torch.train.step import TrainState
    p = param_pspecs(state.params, mesh, strategy)
    opt = state.opt
    if isinstance(opt.nu, list):                      # adafactor
        nu = adafactor_nu_specs(state.params, mesh, strategy)
    else:
        nu = None if opt.nu is None else p
    return TrainState(p, OptState((), None if opt.mu is None else p, nu),
                      None if state.ef is None else p)
