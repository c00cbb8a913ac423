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

Gradients come from ``torch.autograd.grad`` with respect to the parameter
tensors (zeros for a parameter the loss does not reach); the codec, clipping
and the optimizer run without autograd. The eager step (``mode="eager"``,
the default) updates the state it is given in place (parameters, optimizer
moments, error-feedback residuals), as the reference's jitted step donates
its state (``donate_argnums=(0,)``), so a full-width model's state is not
held twice.

The compiled steps (``mode="jit"`` or ``"jit_donate"``, the reference's
``jax.jit`` of the step without and with ``donate_argnums=(0,)``) are the
eager step's functions in ``torch.compile(fullgraph=True, dynamic=False)``
regions, each one graph or an error: the forward (the loss, with the
overlap body's per-layer gathers and Megatron collectives), whose backward
AOT autograd compiles with it and ``torch.autograd.grad`` runs, and the
update (the gradients' reduction and codec, the clip, the optimizer); the
overlap body's eager gathers are a third. (One graph for the whole step,
with ``torch.func.grad_and_value`` as the LeNet iteration takes its grads,
cannot hold the kernels: ``torch.func`` does not differentiate
``torch.library`` custom ops.) The learning rate and AdamW's bias
corrections enter as 0-d tensors and the step count stays on the host, so
one compile serves every step. ``jit_donate`` writes the new state into
the tensors it is given, as the eager step does; ``jit`` leaves them as
they are and returns new tensors (the update clones the state inside its
graph first), as ``jax.jit`` without donation returns new buffers.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.optim.optimizers import OptState, adamw_corrections
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


def _forward(cfg: ModelConfig, tcfg: TrainConfig):
    """(params, batch, axes=None) -> (loss, metrics): the step's forward."""
    def forward(params, batch, axes=None):
        return MD.loss_fn(params, cfg, batch, remat=tcfg.remat_policy,
                          ce_impl=tcfg.ce_impl, axes=axes)
    return forward


def _grad_fn(cfg: ModelConfig, tcfg: TrainConfig, forward=None):
    """(params, batch, axes=None) -> (loss, metrics, grads) of ``forward``
    (a compiled one; by default ``_forward``'s), all detached."""
    forward = forward or _forward(cfg, tcfg)

    def loss_and_grads(params, batch, axes=None):
        leaves, tracked = _leaves_needing_grad(params)
        loss, metrics = forward(tracked, batch, axes)
        grads = _grads(loss, leaves, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads
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


MODES = ("eager", "jit", "jit_donate")


def _backend(gm, example_inputs):
    """Inductor's code generation for a graph of CUDA tensors; on the CPU
    the same graphs and AOT autograd run op by op (``aot_eager``): nothing
    is timed there, and inductor's C++ compiles cost tens of seconds a
    step."""
    if any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
           for x in example_inputs):
        from torch._inductor.compile_fx import compile_fx
        return compile_fx(gm, example_inputs)
    from torch._dynamo.backends.debugging import aot_eager
    return aot_eager(gm, example_inputs)


def compile_fullgraph(fn):
    """``torch.compile(fn, fullgraph=True, dynamic=False)``: one graph per
    shape, or an error (never a graph break), by ``_backend``."""
    return torch.compile(fn, fullgraph=True, dynamic=False, backend=_backend)


def _check_mode(mode: str, tcfg: TrainConfig, microbatches: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if mode != "eager" and (tcfg.optimizer == "adafactor" or microbatches > 1):
        raise NotImplementedError(
            "a compiled step takes an elementwise optimizer (adamw, sgd) "
            "and one microbatch")


def _hyper(state: TrainState, tcfg: TrainConfig, device):
    """(lr, AdamW's corrections or None) of the update ``state`` is at, as
    0-d fp32 tensors on ``device``: a compiled update's inputs."""
    lr = warmup_cosine(state.opt.step, peak_lr=tcfg.learning_rate,
                       warmup_steps=tcfg.warmup_steps,
                       total_steps=tcfg.total_steps)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    corr = (tuple(map(t, adamw_corrections(tcfg, state.opt.step + 1)))
            if tcfg.optimizer == "adamw" else None)
    return lr, t(lr), corr


def _clone_state(mode: str, *trees):
    """``jit``: copies of the trees, which the update then writes into;
    ``eager`` and ``jit_donate``: the trees themselves."""
    if mode != "jit":
        return trees
    return tuple(None if t is None else tree_map(torch.clone, t) for t in trees)


def _leaves_needing_grad(tree):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
    return leaves, tree_unflatten(tree, leaves)


def _grads(loss, leaves, like):
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return tree_unflatten(like, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    microbatches: int = 1, mode: str = "eager"):
    """Returns train_step(state, batch) -> (state, metrics); the state that
    comes back holds the tensors of the one passed in, updated (``jit``: new
    tensors). The forward and the update are the same functions in every
    mode; ``jit`` and ``jit_donate`` compile each (the module docstring)."""
    _check_mode(mode, tcfg, microbatches)
    _, opt_update = make_optimizer(tcfg.optimizer)

    def update(params, grads, opt, ef, lr, corr):
        """Wire-format compression (numerics-exact w.r.t. a shared-scale
        compressed all-reduce; see dist/compression.py), the clip and the
        optimizer: (params, opt, ef, global norm)."""
        params, mu, nu, ef = _clone_state(mode, params, opt.mu, opt.nu, ef)
        opt = opt._replace(mu=mu, nu=nu)
        if tcfg.grad_compression != "none":
            grads, ef = compress_tree(grads, tcfg.grad_compression, ef)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        kw = {} if corr is None else {"corrections": corr}
        params, opt = opt_update(params, grads, opt, tcfg, lr, **kw)
        return params, opt, ef, gnorm

    forward = _forward(cfg, tcfg)
    if mode != "eager":
        forward, update = compile_fullgraph(forward), compile_fullgraph(update)
    grad_fn = _grad_fn(cfg, tcfg, forward)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        loss, metrics, grads = _loss_and_grads(grad_fn, state.params, batch,
                                               microbatches)
        if mode == "eager":
            lr = warmup_cosine(state.opt.step, peak_lr=tcfg.learning_rate,
                               warmup_steps=tcfg.warmup_steps,
                               total_steps=tcfg.total_steps)
            lr_in, corr, opt = lr, None, state.opt
        else:   # the graph holds no step count
            lr, lr_in, corr = _hyper(state, tcfg, loss.device)
            opt = state.opt._replace(step=0)
        params, opt, ef, gnorm = update(state.params, grads, opt, state.ef,
                                        lr_in, corr)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, loss=loss)
        return (TrainState(params, opt._replace(step=state.opt.step + 1), ef),
                metrics)

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


def overlap_transient_bytes(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                            strategy="dp", state_specs=None) -> Tuple[int, int]:
    """(eager_bytes, stream_chunk_bytes) the overlap body's gathers add per
    rank beyond the persistent parameter shards (the planner's memory term).

    Eager tensors (embedding, lm_head, norms, zamba groups, an
    encoder-decoder's segments) hold their whole gathered array for the
    step; a streamed segment materializes one layer's gathered slice at a
    time, so its term is the largest single-layer chunk over the segments.
    ``LocalDim`` dims are never gathered. ``mesh`` may be a ``Mesh`` or a
    plain ``{axis: size}`` mapping; nothing is allocated (``param_shapes``).
    The arithmetic runs over the reference's leaves (``tree.reference_leaves``:
    a segment's layers summed into its stacked leaf) with the reference's
    floor divisions, so the integers are the reference's."""
    strat = resolve_strategy(strategy)
    shapes = MD.param_shapes(cfg)
    if state_specs is None:
        state_specs = sharded_state_specs(cfg, tcfg, mesh, strat, shapes=shapes)
    # the wire format changes no byte; "none" keeps the int8_ef check on
    # model-local tensors (a step the body cannot run) out of the pricing
    plans = _overlap_plans(cfg, dataclasses.replace(tcfg, grad_compression="none"),
                           mesh, state_specs.params, shapes)
    sizes = axis_sizes(mesh)
    per = []
    tree_map(lambda p, pl: per.append((p.numel() * p.element_size(), pl)),
             shapes, plans)
    eager, stream = 0, defaultdict(int)
    for key, idx in reference_leaves(shapes):
        nbytes = sum(per[i][0] for i in idx)
        pl = per[idx[0]][1]
        local, stream_div = 1, 1
        for ax in pl.axes:
            if isinstance(ax, LocalDim):
                local *= int(ax.size)
            elif isinstance(ax, StreamDim):
                for a in ax.entry if isinstance(ax.entry, tuple) else (ax.entry,):
                    stream_div *= int(sizes.get(a, 1))
        if pl.streamed:
            if stream_div > 1:        # else a degenerate mesh: nothing gathered
                stream[key[1]] += (nbytes // local) // max(len(idx), 1)
            continue
        gdiv = 1
        for entry in pl.gather:
            for a in () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,)):
                gdiv *= int(sizes.get(a, 1))
        eager += nbytes // local - nbytes // (local * gdiv)
    return int(eager), int(max(stream.values(), default=0))


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
                            overlap: bool = False, timer=None,
                            mode: str = "eager"):
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
    ``mode`` "jit" or "jit_donate" compiles the overlap body (the module
    docstring; ``compile_fullgraph``): its eager gathers,
    its forward (the streamed gathers' reductions in the backward AOT
    autograd compiles with it) and its reduce-clip-update, each one graph;
    it takes no ``timer``.

    Restrictions, as the reference's: an elementwise optimizer (adamw or
    sgd: adafactor's factored moments take means over dims this path
    shards), a batch axis in the mesh, and the global batch divisible over
    it (``sharded_batch_ok``)."""
    if tcfg.optimizer == "adafactor":
        raise NotImplementedError(
            "sharded path supports elementwise optimizers (adamw/sgd); "
            "adafactor's factored moments need full-dim means")
    _check_mode(mode, tcfg, microbatches)
    if mode != "eager" and (not overlap or timer is not None):
        raise NotImplementedError("a compiled sharded step is the overlap "
                                  "body, untimed by regions")
    batch_axes = _mesh_batch_axes(mesh)
    if not batch_axes:
        raise ValueError(f"mesh {dict(mesh.shape)} has no batch axis "
                         f"({BATCH_AXES}); the gradient all-reduce needs one")
    _, opt_update = make_optimizer(tcfg.optimizer)
    grad_fn = _grad_fn(cfg, tcfg)
    strat = resolve_strategy(strategy)
    wire = tcfg.grad_compression
    shapes = MD.param_shapes(cfg)
    p_specs = sharded_state_specs(cfg, tcfg, mesh, strat, shapes).params
    batch_group = mesh.group(batch_axes)
    n_batch = n_batch_shards(mesh)
    region = timer if timer is not None else (lambda name: nullcontext())

    def update(state, shards, gnorm, loss, metrics, lr=None, corr=None):
        """The optimizer on this rank's slices (of ``state``'s tensors);
        the metrics meaned over the batch axes. ``lr`` and ``corr``: a
        compiled update's tensors (else from ``state``'s step count)."""
        if lr is None:
            lr = warmup_cosine(state.opt.step, peak_lr=tcfg.learning_rate,
                               warmup_steps=tcfg.warmup_steps,
                               total_steps=tcfg.total_steps)
        kw = {} if corr is None else {"corrections": corr}
        new_params, new_opt = opt_update(state.params, shards, state.opt, tcfg,
                                         lr, **kw)
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
                reduced = _reduce_grads(grads, batch_group, wire, state.ef)
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
    stream_mode = "int8" if wire == "int8_ef" else wire

    def reduce(grads, ef, loss):
        """The grads' mean over the batch axes (but the streamed ones',
        reduced in their backward) and the loss's."""
        return (_reduce_grads(grads, batch_group, wire, ef, done=streamed),
                _pmean(loss, batch_group, n_batch))

    def clip_shards(reduced):
        """Partition-aware clip: each rank's squares weighted by
        1/replication, one SUM over the whole mesh; then this rank's
        slices. Returns (slices, global norm)."""
        contribs = tree_map(lambda g, pl: g.square().sum() / pl.repl,
                            reduced, plans)
        local = torch.stack(tree_leaves(contribs)).sum()
        gnorm = torch.sqrt(all_reduce(local, "sum", whole))
        scale = torch.clamp(torch.full_like(gnorm, tcfg.grad_clip)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)
        clipped = tree_map(lambda g: g * scale, reduced)
        return tree_map(lambda g, pl: shard_of_full(g, pl.gather, mesh),
                        clipped, plans), gnorm

    if mode != "eager":
        return _compiled_overlap_body(cfg, tcfg, mesh, mode, plans,
                                      plan_axes, batch_group, stream_mode,
                                      reduce, clip_shards, update)

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
                reduced, loss = reduce(grads, state.ef, loss)
                del grads
            with region("update"), torch.no_grad():
                shards, gnorm = clip_shards(reduced)
                return update(state, shards, gnorm, loss, metrics)

    return overlap_body


def _compiled_overlap_body(cfg, tcfg, mesh, mode, plans, plan_axes,
                           batch_group, stream_mode, reduce, clip_shards,
                           update):
    """The overlap body as three compiled regions: the eager gathers, the
    forward under the step's ``manual_mode`` (entered outside the graphs: a
    module global, constant for a trace), and reduce-clip-update on the
    state (cloned first under ``jit``) with its step count held at 0 in the
    graph, the lr and AdamW's corrections as tensors."""

    def gather(params):
        return tree_map(lambda p, pl: gather_to_full(p, pl.gather, mesh),
                        params, plans)

    def forward(compute, batch):
        return MD.loss_fn(compute, cfg, batch, remat=tcfg.remat_policy,
                          ce_impl=tcfg.ce_impl, axes=plan_axes)

    def update_step(state, grads, loss, metrics, lr, corr):
        params, mu, nu, ef = _clone_state(mode, state.params, state.opt.mu,
                                          state.opt.nu, state.ef)
        state = TrainState(params, OptState(0, mu, nu), ef)
        with torch.no_grad():
            reduced, loss = reduce(grads, ef, loss)
            shards, gnorm = clip_shards(reduced)
            return update(state, shards, gnorm, loss, metrics, lr, corr)

    gather_c, forward_c, update_c = map(compile_fullgraph,
                                        (gather, forward, update_step))

    def body(state: TrainState, batch):
        with manual_mode(mesh, batch_group, stream_mode):
            compute = gather_c(state.params)
            leaves, compute_g = _leaves_needing_grad(compute)
            loss, metrics = forward_c(compute_g, batch)
            grads = _grads(loss, leaves, compute)
            lr, lr_t, corr = _hyper(state, tcfg, loss.device)
            new, metrics = update_c(
                state._replace(opt=state.opt._replace(step=0)), grads,
                loss.detach(),
                {k: v.detach() for k, v in metrics.items()}, lr_t, corr)
        metrics["lr"] = lr
        return (new._replace(opt=new.opt._replace(step=state.opt.step + 1)),
                metrics)

    return body
