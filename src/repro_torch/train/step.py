"""Train step: loss → (micro-batched) grads → compression → clip → update
(``repro.train.step``).

Two paths share the same TrainState and numerics:

* ``make_train_step`` — one device; the reference's GSPMD step on a mesh of
  one.
* ``make_sharded_train_step`` — the manual-collectives step, the
  counterpart of the reference's ``shard_map``: every rank of a ``Mesh``
  (``dist.sharding``, a world of ``dist.pool`` ranks) runs the body on its
  own shards, and every collective is written out over the mesh's process
  groups, so it can be measured and compressed. Parameters and optimizer
  moments are held sharded per the strategy's logical rules
  (``param_pspecs``); the batch is split over the batch axes. The legacy
  body gathers the parameters whole, computes the local gradient, means it
  over the batch axes through the compressed collective, clips, and each
  rank updates its own slice. The overlap body keeps the model-sharded
  dims of the layers that can compute on a slice local (Megatron splits,
  ``LocalDim``) and gathers every other sharded dim of a segment's layer
  inside that layer (``StreamDim``, ``dist.sharding.stream_gather``).

Each function of (state, batch) runs eagerly. Gradients come from
``torch.autograd.grad`` with respect to the parameter tensors (zeros for a parameter the loss does not reach);
the codec, clipping and the optimizer run without autograd. The step
updates the state it is given in place (parameters, optimizer moments,
error-feedback residuals), as the reference's jitted step donates its state
(``donate_argnums=(0,)``), so a full-width model's state is not held twice.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.dist.compression import (compress_tree,
                                          compressed_psum_mean_ef_leaf,
                                          compressed_psum_mean_leaf,
                                          init_error_feedback)
from repro_torch.dist.sharding import (BATCH_AXES, Mesh, all_reduce, axis_sizes,
                                       gather_to_full, manual_mode,
                                       param_pspecs, resolve_strategy,
                                       shard_of_full, spec_entries)
from repro_torch.models import model as MD
from repro_torch.models.layers import LocalDim, StreamDim
from repro_torch.optim import clip_by_global_norm, make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import (reference_leaves, tree_leaves, tree_map,
                              tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ef: Any            # error-feedback buffers (grad compression) or None


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    params = MD.init_model(cfg, seed=seed, device=device)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    opt = opt_init(params, tcfg)
    ef = (init_error_feedback(params)
          if tcfg.grad_compression == "int8_ef" else None)
    return TrainState(params, opt, ef)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """``n`` batches of B // n rows each, in order."""
    def split(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} microbatches")
        return x.reshape(n, B // n, *x.shape[1:]).unbind(0)
    cols = {k: split(v) for k, v in batch.items()}
    return [{k: cols[k][i] for k in batch} for i in range(n)]


def _grad_fn(cfg: ModelConfig, tcfg: TrainConfig):
    def loss_and_grads(params, batch, axes=None):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = MD.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                   remat=tcfg.remat_policy,
                                   ce_impl=tcfg.ce_impl, axes=axes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)
    return loss_and_grads


def _loss_and_grads(grad_fn, params, batch, microbatches: int, axes=None):
    """(loss, metrics, grads) with optional micro-batch accumulation.

    With ``microbatches <= 1`` grads keep their parameters' dtypes; the
    accumulated path returns fp32 grads, the mean over the microbatches.
    ``axes`` is the overlap body's marker tree."""
    if microbatches <= 1:
        return grad_fn(params, batch, axes)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    losses, mlist = [], []
    for mb in _split_microbatches(batch, microbatches):
        loss, m, g = grad_fn(params, mb, axes)
        acc = tree_map(lambda a, gg: a + gg.float() / microbatches, acc, g)
        losses.append(loss)
        mlist.append(m)
    metrics = {k: torch.stack([m[k].float() for m in mlist]).mean()
               for k in mlist[0]}
    return torch.stack(losses).mean(), metrics, acc


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics); the state that
    comes back holds the tensors of the one passed in, updated."""
    _, opt_update = make_optimizer(tcfg.optimizer)
    grad_fn = _grad_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        loss, metrics, grads = _loss_and_grads(grad_fn, params, batch,
                                               microbatches)

        # wire-format compression (numerics-exact w.r.t. a shared-scale
        # compressed all-reduce; see dist/compression.py)
        new_ef = state.ef
        if tcfg.grad_compression != "none":
            grads, new_ef = compress_tree(grads, tcfg.grad_compression,
                                          state.ef)

        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = warmup_cosine(state.opt.step, peak_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        new_params, new_opt = opt_update(params, grads, state.opt, tcfg, lr)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, loss=loss)
        return TrainState(new_params, new_opt, new_ef), metrics

    return train_step


# ---------------------------------------------------------------------------
# Manual-collectives (sharded) path
# ---------------------------------------------------------------------------

def _mesh_batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in axis_sizes(mesh))


def n_batch_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _mesh_batch_axes(mesh):
        n *= sizes[a]
    return n


def sharded_batch_ok(mesh, global_batch: int) -> bool:
    """The sharded step needs the batch evenly divided over the batch axes."""
    return global_batch % n_batch_shards(mesh) == 0


def sharded_state_specs(cfg: ModelConfig, tcfg: TrainConfig, mesh, strategy,
                        shapes=None) -> TrainState:
    """A TrainState of specs: parameters and optimizer moments follow the
    strategy's logical rules; the step count is a host integer; every
    rank's error-feedback residual is its own, whole (the reference's
    per-rank ``[n_batch_shards, ...]`` buffer, this rank's row), spec ().
    ``shapes`` defaults to ``MD.param_shapes(cfg)``."""
    if shapes is None:
        shapes = MD.param_shapes(cfg)
    p = param_pspecs(shapes, mesh, strategy)
    opt = OptState((), p, p if tcfg.optimizer == "adamw" else None)
    ef = (tree_map(lambda x: (), shapes) if tcfg.grad_compression == "int8_ef"
          else None)
    return TrainState(p, opt, ef)


def sharded_state_shardings(tree, specs, mesh: Mesh):
    """This rank's slice of each tensor of a whole ``tree`` under ``specs``
    (owned copies): the placement the reference's NamedShardings give a
    state's leaves."""
    return tree_map(lambda x, s: shard_of_full(x, s, mesh).clone(), tree, specs)


def init_sharded_train_state(cfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                             strategy, *, seed: int = 0, device="cuda",
                             params=None) -> TrainState:
    """This rank's TrainState: the whole parameters (``init_model`` from
    ``seed`` on ``device``, or ``params``) cut to its slices, the optimizer
    moments made for the slices, and its own whole fp32 error-feedback
    residual under int8_ef (that is what error feedback means: the
    residual belongs to the rank whose contribution was rounded)."""
    if params is None:
        params = MD.init_model(cfg, seed=seed, device=device)
    local = sharded_state_shardings(params, param_pspecs(params, mesh, strategy),
                                    mesh)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    ef = (init_error_feedback(params)
          if tcfg.grad_compression == "int8_ef" else None)
    return TrainState(local, opt_init(local, tcfg), ef)


class _LeafPlan(NamedTuple):
    """Per-tensor decision of the overlap body (port layout)."""
    axes: Tuple        # entries: logical name, LocalDim or StreamDim
    gather: Tuple      # eager-gather spec (entries only on eager dims)
    streamed: bool     # any StreamDim: the grad arrives reduced and sliced
    repl: float        # ranks holding each element of the reduced grad


def _streamable_tree(cfg: ModelConfig, params):
    """True at the tensors whose per-layer streaming is safe: the layers of
    every segment but a zamba group's (its shared block and nested inner
    stack keep eager gathers); nothing in an encoder-decoder."""
    flags = tree_map(lambda p: False, params)
    if cfg.is_encoder_decoder:
        return flags
    for i, seg in enumerate(MD.build_segments(cfg)):
        if seg.kind != "zamba_group":
            flags["segments"][i] = tree_map(lambda p: True,
                                            params["segments"][i])
    return flags


def _overlap_plans(cfg: ModelConfig, tcfg: TrainConfig, mesh, p_specs, shapes):
    """Classify every sharded dim of every tensor, in priority order:
    partitioned (``LocalDim``: model-sharded and ``tp_live_axes`` says the
    layer computes on the slice; the MoE router's expert dim, its output,
    stays whole), streamed (``StreamDim``: any other sharded dim of a
    segment layer, gathered inside the layer) or eager (the legacy whole
    gather: embedding, final norm, lm_head, mtp, zamba groups, an
    encoder-decoder)."""
    sizes = axis_sizes(mesh)
    n_total = 1
    for v in sizes.values():
        n_total *= v
    live = MD.tp_live_axes(cfg, sizes.get("model", 1))

    def one(p, ax, spec, can_stream):
        names = ax.names[::-1] if ax.transposed else ax.names
        nd = len(names)
        axes, gather = [], []
        shard, streamed = 1, False
        for i, (logical, entry) in enumerate(zip(names, spec_entries(spec, nd))):
            if entry is None:
                axes.append(logical)
                gather.append(None)
                continue
            ax_names = entry if isinstance(entry, tuple) else (entry,)
            if (ax_names == ("model",) and logical in live
                    and not (logical == "expert" and i == nd - 1)):
                axes.append(LocalDim(logical, "model", sizes["model"]))
                gather.append(None)
                shard *= sizes["model"]
            elif can_stream:
                axes.append(StreamDim(logical, entry))
                gather.append(None)
                streamed = True
                for a in ax_names:
                    shard *= sizes[a]
            else:
                axes.append(logical)
                gather.append(entry)
        if (tcfg.grad_compression == "int8_ef" and not streamed
                and any(isinstance(a, LocalDim) for a in axes)):
            # the reference's residual is whole-leaf and cannot take a slice
            raise NotImplementedError(
                "int8_ef on a model-local leaf that is not streamed")
        return _LeafPlan(tuple(axes), tuple(gather), streamed,
                         float(n_total // shard))

    return tree_map(one, shapes, MD.param_axes(shapes), p_specs,
                    _streamable_tree(cfg, shapes))


def _reduce_grads(grads, group, mode: str, ef, done=None):
    """The grads' mean over ``group`` in the wire format, one collective per
    reference leaf (its layers on one int8 scale, as the reference's stacked
    leaf), in fp32. Where ``done`` is True (a streamed leaf, reduced in its
    layer's backward) the grad passes as it is; int8_ef writes the new
    residuals into ``ef``."""
    g = [x.float() for x in tree_leaves(grads)]
    skip = (tree_leaves(tree_map(lambda x, d: d, grads, done))
            if done is not None else [False] * len(g))
    errs = (None if ef is None
            else tree_leaves(tree_map(lambda x, e: e, grads, ef)))
    out = list(g)
    for _, idx in reference_leaves(grads):
        if skip[idx[0]]:
            continue
        xs = [g[i] for i in idx]
        if mode == "int8_ef":
            means, new = compressed_psum_mean_ef_leaf(xs, group,
                                                      [errs[i] for i in idx])
            for i, e in zip(idx, new):
                errs[i].copy_(e)
        else:
            means = compressed_psum_mean_leaf(xs, group, mode)
        for i, m in zip(idx, means):
            out[i] = m
    return tree_unflatten(grads, out)


def _pmean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return all_reduce(x.float(), "sum", group) / n


class RegionTimer:
    """Host-clock milliseconds of each region of a step, the device
    synchronised at both ends (the reference's ``obs:`` scopes:
    gather_params, grad_compute, grad_reduce, update). ``ms[name]`` lists
    one time per step."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms = defaultdict(list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                            strategy="dp", microbatches: int = 1,
                            overlap: bool = False, timer=None):
    """The measured multi-rank step: ``step(state, batch)`` on each rank of
    ``mesh``, with this rank's state (``init_sharded_train_state``) and its
    rows of the global batch (``launch.specs.batch_shardings``); returns
    (state, metrics), the state updated in place.

    Per step, on each rank (legacy body, ``overlap=False``):

      1. all-gather the parameter shards to whole tensors
         (``gather_to_full``; nothing for dp);
      2. the gradients of the local rows (micro-batched if asked);
      3. their mean over the batch axes through the compressed collective,
         one per reference leaf (``compressed_psum_mean`` /
         ``compressed_psum_mean_ef``, the residual staying on the rank);
      4. clip by the global norm of the whole reduced gradient (the same on
         every rank), cut each gradient to this rank's slice and update
         locally (the optimizer is elementwise).

    The batch is replicated over ``model``: every model rank computes the
    same whole gradients. With ``overlap=True`` the step partitions the
    compute (``_overlap_plans``): ``LocalDim`` dims stay on their slice with
    Megatron's collectives in the layers, ``StreamDim`` dims are gathered
    per layer with the reduce-scatter in the gather's backward (int8_ef
    falls back to int8 there: error feedback cannot thread through a
    backward, identical on a fresh residual), the rest is gathered eagerly;
    the clip sums every rank's squares weighted by 1/replication over the
    whole mesh. ``timer`` (a ``RegionTimer``) times the four regions.

    Restrictions, as the reference's: an elementwise optimizer (adamw or
    sgd: adafactor's factored moments take means over dims this path
    shards), a batch axis in the mesh, and the global batch divisible over
    it (``sharded_batch_ok``)."""
    if tcfg.optimizer == "adafactor":
        raise NotImplementedError(
            "sharded path supports elementwise optimizers (adamw/sgd); "
            "adafactor's factored moments need full-dim means")
    batch_axes = _mesh_batch_axes(mesh)
    if not batch_axes:
        raise ValueError(f"mesh {dict(mesh.shape)} has no batch axis "
                         f"({BATCH_AXES}); the gradient all-reduce needs one")
    _, opt_update = make_optimizer(tcfg.optimizer)
    grad_fn = _grad_fn(cfg, tcfg)
    strat = resolve_strategy(strategy)
    mode = tcfg.grad_compression
    shapes = MD.param_shapes(cfg)
    p_specs = sharded_state_specs(cfg, tcfg, mesh, strat, shapes).params
    batch_group = mesh.group(batch_axes)
    n_batch = n_batch_shards(mesh)
    region = timer if timer is not None else (lambda name: nullcontext())

    def update(state, shards, gnorm, loss, metrics):
        """The optimizer on this rank's slices; the metrics meaned over the
        batch axes."""
        lr = warmup_cosine(state.opt.step, peak_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        new_params, new_opt = opt_update(state.params, shards, state.opt, tcfg, lr)
        metrics = {k: _pmean(v, batch_group, n_batch) for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr, loss=loss)
        return TrainState(new_params, new_opt, state.ef), metrics

    def body(state: TrainState, batch):
        with manual_mode(mesh):
            params = state.params
            with region("gather_params"):
                full = tree_map(lambda p, s: gather_to_full(p, s, mesh),
                                params, p_specs)
            with region("grad_compute"):
                loss, metrics, grads = _loss_and_grads(grad_fn, full, batch,
                                                       microbatches)
            del full
            with region("grad_reduce"), torch.no_grad():
                reduced = _reduce_grads(grads, batch_group, mode, state.ef)
                del grads
                loss = _pmean(loss, batch_group, n_batch)
            with region("update"), torch.no_grad():
                reduced, gnorm = clip_by_global_norm(reduced, tcfg.grad_clip)
                shards = tree_map(lambda g, s: shard_of_full(g, s, mesh),
                                  reduced, p_specs)
                return update(state, shards, gnorm, loss, metrics)

    if not overlap:
        return body

    plans = _overlap_plans(cfg, tcfg, mesh, p_specs, shapes)
    plan_axes = tree_map(lambda p, pl: pl.axes, shapes, plans)
    streamed = tree_map(lambda p, pl: pl.streamed, shapes, plans)
    whole = mesh.group(mesh.axis_names)
    stream_mode = "int8" if mode == "int8_ef" else mode

    def overlap_body(state: TrainState, batch):
        with manual_mode(mesh, batch_group, stream_mode):
            params = state.params
            with region("gather_params"):
                # eager gathers only: streamed and local dims stay sharded
                compute = tree_map(lambda p, pl: gather_to_full(p, pl.gather, mesh),
                                   params, plans)
            with region("grad_compute"):
                loss, metrics, grads = _loss_and_grads(
                    grad_fn, compute, batch, microbatches, axes=plan_axes)
            del compute
            with region("grad_reduce"), torch.no_grad():
                reduced = _reduce_grads(grads, batch_group, mode, state.ef,
                                        done=streamed)
                del grads
                loss = _pmean(loss, batch_group, n_batch)
            with region("update"), torch.no_grad():
                # partition-aware clip: each rank's squares weighted by
                # 1/replication, one SUM over the whole mesh
                contribs = tree_map(lambda g, pl: g.square().sum() / pl.repl,
                                    reduced, plans)
                local = torch.stack(tree_leaves(contribs)).sum()
                gnorm = torch.sqrt(all_reduce(local, "sum", whole))
                scale = torch.clamp(torch.full_like(gnorm, tcfg.grad_clip)
                                    / torch.clamp(gnorm, min=1e-9), max=1.0)
                clipped = tree_map(lambda g: g * scale, reduced)
                shards = tree_map(lambda g, pl: shard_of_full(g, pl.gather, mesh),
                                  clipped, plans)
                return update(state, shards, gnorm, loss, metrics)

    return overlap_body
