"""Pool jobs for the port's tests (``repro_torch.dist.pool.Pool.run``).

A spawned rank imports a job by its module path, so the jobs the tests
need beyond ``repro_torch.dist.probes`` live here, in a module that imports
torch and the port only: never JAX, never ``repro``.
"""
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import tp_f, tp_g


def imported_roots(ctx):
    """The roots of this rank's imported modules among jax, jaxlib, repro."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & {"jax", "jaxlib", "repro"})


def split_mlp_loss(x, w1, w2, group=None):
    """sum(tanh(tanh(x·w1ᵀ)·w2ᵀ)²), with w1's rows and w2's columns split
    over ``group`` (Megatron's f/g pair) when it is given."""
    if group is not None:
        x = tp_f(group, x)
    h = F.linear(torch.tanh(F.linear(x, w1)), w2)
    if group is not None:
        h = tp_g(group, h)
    return torch.tanh(h).square().sum()


def split_mlp_grads(ctx, x, w1, w2):
    """Grads of ``split_mlp_loss`` on this model rank's slice of w1's rows
    and w2's columns, through ``torch.func.grad``: (gx, gw1 slice, gw2
    slice, loss)."""
    mesh = ctx.mesh
    m, r = mesh.shape["model"], mesh.index("model")
    rows = slice(r * w1.shape[0] // m, (r + 1) * w1.shape[0] // m)
    args = (torch.from_numpy(x), torch.from_numpy(w1[rows]),
            torch.from_numpy(np.ascontiguousarray(w2[:, rows])))
    grads, loss = torch.func.grad_and_value(split_mlp_loss, argnums=(0, 1, 2))(
        *args, mesh.group("model"))
    return [g.numpy() for g in grads] + [float(loss)]


def raise_on(ctx, rank):
    """Raise on ``rank``; return the rank elsewhere."""
    if ctx.rank == rank:
        raise ValueError(f"job failed on purpose on rank {rank}")
    return ctx.rank


def sharded_step(ctx, cfg, tcfg, strategy, overlaps, tree, batch):
    """One step of ``make_sharded_train_step`` per body of ``overlaps``
    (False: legacy, True: overlap), each from the reference's whole params
    ``tree`` (``pvalues``, numpy) converted and cut to this rank's slices,
    on this rank's rows of the global ``batch``. Returns, per body, the new
    params gathered whole (port tensors in ``tree_leaves`` order, rank 0
    only), this rank's error-feedback residuals, the lr and the loss."""
    from repro_torch.dist.probes import _lm_rank_inputs
    from repro_torch.dist.sharding import gather_to_full, param_pspecs
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train.step import make_sharded_train_step
    from repro_torch.tree import tree_leaves, tree_map

    mesh = ctx.mesh
    full = params_from_jax(tree, cfg, device=ctx.device)
    specs = param_pspecs(full, mesh, strategy)
    out = {}
    for overlap in overlaps:
        state, rows = _lm_rank_inputs(ctx, cfg, tcfg, strategy, 0, batch, full)
        step = make_sharded_train_step(cfg, tcfg, mesh, strategy,
                                       overlap=overlap)
        state, metrics = step(state, rows)
        new = tree_map(lambda p, s: gather_to_full(p, s, mesh), state.params,
                       specs)
        out[overlap] = {
            "params": ([x.float().cpu().numpy() for x in tree_leaves(new)]
                       if ctx.rank == 0 else None),
            "ef": (None if state.ef is None else
                   [x.cpu().numpy() for x in tree_leaves(state.ef)]),
            "lr": float(metrics["lr"]), "loss": float(metrics["loss"])}
    return out


def raise_in_collective(ctx, rank):
    """Raise on ``rank`` while every other rank of the mesh waits for it in
    an all-reduce; return this rank's process id elsewhere."""
    import os
    import torch.distributed as dist
    if ctx.rank == rank:
        raise ValueError(f"rank {rank} left its peers in a collective")
    dist.all_reduce(torch.ones(1), group=ctx.mesh.group(ctx.mesh.axis_names))
    return os.getpid()


def pid(ctx):
    """This rank's process id."""
    import os
    return os.getpid()


def gspmd_steps(ctx, cfg, tcfg, strategy, tree, batches, microbatches=1):
    """``make_gspmd_train_step`` over the global ``batches`` (numpy dicts)
    from the reference's whole params ``tree`` (``pvalues``, numpy),
    converted and cut to this rank's slices of the state. Returns each
    step's loss and grad norm, and on rank 0 the final state gathered whole
    (numpy, ``tree_leaves`` order): params, mu, nu and the int8_ef
    residual, each None where the state has none."""
    from repro_torch.dist.sharding import gather_to_full
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train.step import (gspmd_state_specs, init_gspmd_train_state,
                                        make_gspmd_train_step)
    from repro_torch.tree import tree_leaves, tree_map

    mesh = ctx.mesh
    full = params_from_jax(tree, cfg, device=ctx.device)
    state = init_gspmd_train_state(cfg, tcfg, mesh, strategy, params=full)
    step = make_gspmd_train_step(cfg, tcfg, mesh, strategy, microbatches=microbatches)
    losses, gnorms = [], []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v).to(ctx.device)
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    specs = gspmd_state_specs(cfg, tcfg, mesh, strategy, shapes=full)

    def whole(t, sp):
        if t is None:
            return None
        t = tree_map(lambda x, s: gather_to_full(x, s, mesh), t, sp)
        return [x.float().cpu().numpy() for x in tree_leaves(t)]

    parts = {"params": whole(state.params, specs.params),
             "mu": whole(state.opt.mu, specs.opt.mu),
             "nu": whole(state.opt.nu, specs.opt.nu),
             "ef": whole(state.ef, specs.ef)}
    return {"losses": losses, "grad_norm": gnorms,
            "state": parts if ctx.rank == 0 else None,
            "transient_bytes": step.transient_bytes}


def ckpt_save_sharded(ctx, directory, cfg, tcfg, strategy, steps, batch):
    """This rank's sharded-path state after ``steps`` steps from seed 0 (so
    the moments are not zero), saved through ``save_sharded`` as
    ``launch.train`` lays it out (step ``steps``)."""
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.launch.train import _ckpt_layout, _ckpt_view
    from repro_torch.train import step as TS
    from repro_torch.train.checkpoint import CheckpointManager
    mesh = ctx.mesh
    state = TS.init_sharded_train_state(cfg, tcfg, mesh, strategy, device="cpu")
    step = TS.make_sharded_train_step(cfg, tcfg, mesh, strategy)
    local = batch_shardings({k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
    for _ in range(steps):
        state, _ = step(state, local)
    _, specs = _ckpt_layout(cfg, tcfg, dict(mesh.shape), strategy, "sharded")
    cm = CheckpointManager(directory, keep=3, async_write=False)
    cm.save_sharded(steps, _ckpt_view(state, "sharded", mesh), mesh=mesh,
                    strategy=strategy, specs=specs)
    return None


def ckpt_restore_whole(ctx, directory, cfg, tcfg, strategy):
    """Restore the latest checkpoint onto this rank's mesh under
    ``strategy`` (the sharded path's layout), gather every leaf whole and
    return rank 0's {leaf key: numpy}, the restore mode and the step."""
    from repro_torch.dist.sharding import gather_to_full
    from repro_torch.launch.train import _ckpt_layout
    from repro_torch.train import checkpoint as CK
    mesh = ctx.mesh
    skel, specs = _ckpt_layout(cfg, tcfg, dict(mesh.shape), strategy, "sharded")
    cm = CK.CheckpointManager(directory, keep=3, async_write=False)
    state, step = cm.restore(skel, shardings=CK.Placement(mesh, specs, ctx.device),
                             strict=True)
    whole = {}
    for path, leaf, spec in CK._walk(state, specs):
        if isinstance(leaf, torch.Tensor):
            leaf = gather_to_full(leaf, spec, mesh).numpy()
        whole[CK._key(path)] = np.asarray(leaf)
    return whole, cm.last_restore_mode, step


def recorded_collectives(ctx, cfg, tcfg, strategy, batch, seq):
    """The collectives one ``make_gspmd_train_step`` step records on this
    rank (``dist.sharding.record_collectives``), from the seeded state and
    batch: (kind, group size, bytes) in the order issued."""
    from repro_torch.data import make_batch_for
    from repro_torch.dist.sharding import record_collectives
    from repro_torch.train.step import init_gspmd_train_state, make_gspmd_train_step

    state = init_gspmd_train_state(cfg, tcfg, ctx.mesh, strategy, device=ctx.device)
    step = make_gspmd_train_step(cfg, tcfg, ctx.mesh, strategy)
    b = {k: v.to(ctx.device) for k, v in make_batch_for(cfg, batch, seq).items()}
    with record_collectives() as log:
        step(state, b)
    return [tuple(r) for r in log]
