"""Placement specs of the sharded programs (``repro.launch.specs``): the
batch's rows (``batch_shardings``), the decode caches by role
(``_batch_entry``, ``_cache_pspec``, ``cache_specs``), the parameters
(``params_only_shardings``) and the train state (``state_shardings``); and
the program of one dry-run cell (``batch_structs``, ``CellProgram``,
``input_specs``).

A spec is a tuple with one entry per dim, the reference's
``PartitionSpec`` (``dist.sharding``); the reference wraps each in a
``NamedSharding`` on its mesh, the port hands the tuples to
``dist.sharding.shard_of_full`` / ``gather_to_full`` on a ``Mesh`` of
process groups. Spec trees have tuple leaves: walk them driven by the
tensor tree they describe. ``mesh`` may be a ``Mesh`` or a plain ``{axis:
size}`` mapping.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Cell programs
# ---------------------------------------------------------------------------

def batch_structs(cfg, B: int, S: int, device="meta") -> Dict[str, torch.Tensor]:
    """Shape-only stand-ins (no data) of a batch of ``B`` sequences of
    ``S``: int32 tokens; the vision stub's fp32 patches, with the tokens cut
    to ``max(S - n, 1)``; an encoder-decoder's fp32 frames. On ``device``,
    or fake under an active ``FakeTensorMode``."""
    out: Dict[str, torch.Tensor] = {}
    s_text = S
    if cfg.frontend == "vision_patch_stub":
        s_text = max(S - cfg.n_frontend_tokens, 1)
        out["patches"] = torch.empty((B, cfg.n_frontend_tokens, cfg.d_model),
                                     dtype=torch.float32, device=device)
    out["tokens"] = torch.empty((B, s_text), dtype=torch.int32, device=device)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.empty((B, cfg.encoder_seq_len, cfg.d_model),
                                    dtype=torch.float32, device=device)
    return out


class CellProgram(NamedTuple):
    """One dry-run cell's program on one rank of its mesh: ``fn(*args)``
    runs it, ``args`` are the rank's fake tensors (made in ``fake_mode``,
    which a trace enters again), ``in_shardings`` the reference's specs of
    each argument (a train state's, its batch's; the parameters', caches'
    and tokens' for serving). ``arg_bytes`` is what the rank holds as
    arguments: its slices of the state (the step count counted as the
    reference's int32 scalar), the rows of the batch it computes on, its
    resident weights and caches."""
    fn: Any
    args: Tuple
    in_shardings: Tuple
    donate_argnums: Tuple[int, ...]
    kind: str               # train | prefill | decode
    fake_mode: Any = None
    arg_bytes: int = 0


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _rank_rows(mesh, n: int) -> int:
    """The rows of ``n`` that ``batch_pspec`` gives a rank."""
    from repro_torch.perf.planner.space import shard_divisor
    return n // shard_divisor(batch_pspec(mesh, 1, n), axis_sizes(mesh))


def _fake_params(cfg, device):
    """``init_model``'s tree as shape-only tensors on ``device``, made in
    the active fake mode (nothing is allocated)."""
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_map
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device=device),
                    MD.param_shapes(cfg))


def input_specs(arch_or_cfg, shape, mesh: Mesh, tcfg=None,
                strategy: str = "fsdp_tp", device="cuda") -> CellProgram:
    """The program of one (arch × shape × mesh) cell as rank ``mesh.rank``
    runs it, with fake arguments on ``device``.

    * train: ``train.step.make_gspmd_train_step`` (the reference's GSPMD
      step) on the rank's slices of ``init_train_state``'s state
      (``gspmd_state_specs``) and the global batch, of which it computes on
      its rows;
    * prefill: the sharded server's layers (``train.serve.serve_plan``:
      ``LocalDim`` slices where ``tp_live_axes`` allows, the rest whole) over
      the rank's rows of the prompts, keeping the caches, and the last
      position's logits;
    * decode: one token against ``shape.seq_len``-slot caches held as the
      sharded server holds them (``local_caches``), at the last slot, with
      an encoder-decoder's cross K/V of ``encoder_seq_len`` frames.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import TrainConfig, cell_is_runnable, get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.dist.sharding import manual_mode
    from repro_torch.models import model as MD
    from repro_torch.train import serve as TS
    from repro_torch.train.step import (gspmd_state_specs,
                                        init_gspmd_train_state,
                                        make_gspmd_train_step)

    cfg = (arch_or_cfg if isinstance(arch_or_cfg, ModelConfig)
           else get_config(arch_or_cfg))
    tcfg = tcfg or TrainConfig()
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"cell not runnable: {why}")
    fake = FakeTensorMode()
    B = shape.global_batch

    if shape.mode == "train":
        specs = gspmd_state_specs(cfg, tcfg, mesh, strategy)
        with fake:
            state = init_gspmd_train_state(cfg, tcfg, mesh, strategy,
                                           params=_fake_params(cfg, device))
            batch = batch_structs(cfg, B, shape.seq_len, device)
        b_specs = {k: batch_pspec(mesh, x.ndim, int(x.shape[0])) for k, x in batch.items()}
        fn = make_gspmd_train_step(cfg, tcfg, mesh, strategy,
                                   microbatches=shape.microbatches)
        return CellProgram(fn, (state, batch), (specs, b_specs), (0,), "train",
                           fake, _nbytes(state) + 4 + sum(
                               _nbytes(x[0]) * _rank_rows(mesh, x.shape[0])
                               for x in batch.values()))

    plan = TS.serve_plan(cfg, mesh, strategy, B)
    rows = _rank_rows(mesh, B) if plan.rows_split else B
    with fake:
        local = TS.local_params(_fake_params(cfg, device), plan, mesh)

    if shape.mode == "prefill":
        with fake:
            batch = batch_structs(cfg, rows, shape.seq_len, device)

        @torch.no_grad()
        def prefill_fn(params, b):
            with manual_mode(mesh):
                h = MD._with_patches(cfg, MD.embed_tokens(params, cfg, b["tokens"]), b)
                positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
                enc_kv = (MD.encode(params, cfg, b["frames"])
                          if cfg.is_encoder_decoder else None)
                h, caches, _ = MD.hidden_forward(params, cfg, h, positions=positions,
                                                 enc_kv=enc_kv, keep_cache=True,
                                                 axes=plan.axes)
                return MD.logits_fn(params, cfg, h[:, -1:])[:, 0], caches

        b_specs = {k: batch_pspec(mesh, x.ndim, B) for k, x in batch.items()}
        return CellProgram(prefill_fn, (local, batch), (plan.param_specs, b_specs),
                           (), "prefill", fake, _nbytes(local) + _nbytes(batch))

    cap = shape.seq_len
    with fake:
        caches = TS.local_caches(cfg, plan, mesh, B, cap, torch.bfloat16, device)
        token = torch.empty((rows, 1), dtype=torch.int32, device=device)
        args = [local, caches, token]
        if cfg.is_encoder_decoder:
            ekv = (cfg.n_layers, rows, cfg.encoder_seq_len, cfg.n_kv_heads,
                   cfg.get_head_dim())
            args += [torch.empty(ekv, dtype=torch.bfloat16, device=device),
                     torch.empty(ekv, dtype=torch.bfloat16, device=device)]
    _, c_specs = cache_specs(cfg, B, cap, mesh)

    @torch.no_grad()
    def decode_fn(params, caches, token, *enc_kv):
        with manual_mode(mesh):
            h = MD.decode_hidden(params, cfg, caches, token, cap - 1,
                                 enc_kv=tuple(enc_kv) or None, axes=plan.axes)
            return MD.logits_fn(params, cfg, h), caches

    shards = [plan.param_specs, c_specs, batch_pspec(mesh, 2, B)]
    if cfg.is_encoder_decoder:
        ekv_spec = _cache_pspec("kv", (cfg.n_layers, B, cfg.encoder_seq_len,
                                       cfg.n_kv_heads, cfg.get_head_dim()), mesh)
        shards += [ekv_spec, ekv_spec]
    # the position: a host int in the port, the reference's int32 scalar
    return CellProgram(decode_fn, tuple(args), tuple(shards), (1,), "decode",
                       fake, _nbytes(args) + 4)
