"""The paper's measured-time experiment: the LeNet-5 hyperparameter sweep
and its cross-architecture counterpart (``repro.perf.sweep``; the arch
half's notes stand above ``ArchPoint``).

Per the paper (§IV.D): random-sample the Table-1 space, measure the time
of a single training iteration (median of 3, after a warm-up iteration),
1500 trials, 900 fit / 600 test. A row's ``time_ms`` is the measured
iteration of the per-device sub-batch plus the per-strategy collective
schedule priced by the cost model (``repro_torch.perf.costmodel``) under
the shared calibration; the row's ``calibration`` column names the link.

The paper's framework axis (TF/MXNet/PyTorch) maps to execution modes:

  eager       the plain iteration, op by op;
  jit         ``torch.compile(fullgraph=True, dynamic=False)`` of the whole
              iteration (grads by ``torch.func.grad_and_value``, then the
              optimizer step), recompiled per sampled config as ``jax.jit``
              retraces per shape;
  jit_donate  the same compiled iteration writing the new parameters into
              the parameter tensors in place, as ``donate_argnums=(0,)``
              reuses the inputs' buffers for the outputs.

An iteration is timed on the host clock ending in a synchronise, as the
reference's ``perf_counter`` + ``block_until_ready``: at LeNet sizes it is
mostly launch and dispatch, which device-side timing would leave out.

With ``sharded=True`` every compiled trial also records
``t_measured_sharded``: the wall clock of a real distributed iteration over
``n_devices`` ranks of a ``dist.pool.Pool`` (one process a rank, gloo, all
ranks on the one card under ``cuda``), the counterpart of the reference's
``shard_map`` iteration over its host device pool:

  * the global batch is split over the "data" axis of the strategy's mesh
    (``mesh_axes_for``); parameters enter as this rank's block of the
    strategy's specs (``lenet_partition_specs``, worked out on the
    reference's layouts) and are all-gathered in the body;
  * a mesh with a model axis that divides fc's 120 splits fc1/fc2
    Megatron-style (``tp_f``/``tp_g``: real activation all-reduces, the fc
    compute split m ways);
  * gradients all-reduce-mean through the wire-compressed collective
    (``dist.compression.compressed_psum_mean``; int8 runs the codec
    kernels on the card), then the optimizer updates the local blocks;
  * the iteration's time is the slowest rank's, each timed iteration
    starting at a barrier; the row records the median.

Eager rows record ``SKIP_EAGER`` (op-by-op dispatch of n ranks measures
Python, not communication) and trials above the pool's world ``SKIP_POOL``.
"""
from __future__ import annotations

import json
import statistics
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.lenet5 import (ACTIVATIONS, BATCH_SIZES, DATASETS,
                                        DIST_STRATEGIES, DROPOUTS,
                                        GRAD_COMPRESSIONS, KERNEL_SIZES,
                                        LEARNING_RATES, LeNet5Config,
                                        N_DEVICES, N_FILTERS, OPTIMIZERS,
                                        PADDING_MODES, POOL_SIZES, STRIDES)
from repro_torch.data.synthetic import lenet_batch
from repro_torch.dist.compression import WIRE_BITS, compressed_psum_mean
from repro_torch.dist.sharding import (Mesh, Spec, all_reduce, gather_to_full,
                                       shard_of_full)
from repro_torch.launch.serve import sync
from repro_torch.models.layers import LocalDim
from repro_torch.models.lenet import (dropout_noise, feature_dims, init_lenet,
                                      lenet_loss)
from repro_torch.obs.trace import current_recorder
from repro_torch.perf.costmodel import (Calibration, load_calibration,
                                        mesh_axes_for)
from repro_torch.perf.features import get_spec, lenet_features
from repro_torch.tree import tree_leaves

MODES = ("jit", "jit_donate", "eager")

# Sentinels recorded in ``SweepRow.sharded_skip`` when the measured
# column is None (the reference's row schema).
SKIP_EAGER = "eager-mode"            # op-by-op dispatch measures python, not comm
SKIP_POOL = "pool-too-small"         # host pool < n_devices
SKIP_NOT_REQUESTED = "not-requested"  # sharded=False sweep


def lenet_act_bytes(cfg: LeNet5Config) -> int:
    """fp32 bytes of the activations at the dense-block boundaries for
    the *global* batch — the tensors a Megatron-style tp split
    all-reduces (flattened conv features entering fc1, plus the fc1/fc2
    outputs). Only tp-family schedules consume this."""
    _, _, flat = feature_dims(cfg)
    return 4 * cfg.batch_size * (flat + 120 + 84)


def comm_seconds(cfg: LeNet5Config, param_bytes: int,
                 calibration: Optional[Calibration] = None) -> float:
    """Per-iteration communication time of one sampled scenario, priced
    through the shared prediction path (``repro_torch.perf.predict``)
    under ``calibration`` (None = the shared one ``load_calibration``
    resolves)."""
    from repro_torch.perf.predict import estimate_comm
    return estimate_comm(cfg.strategy, cfg.n_devices, param_bytes,
                         wire_bits=WIRE_BITS[cfg.compression],
                         act_bytes=lenet_act_bytes(cfg),
                         calibration=calibration).seconds


def sample_config(rng: np.random.Generator) -> LeNet5Config:
    """One Table-1 point: the reference's draws in the reference's order,
    so a seed gives the same configs in both packages."""
    return LeNet5Config(
        kernel_size=int(rng.choice(KERNEL_SIZES)),
        pool_size=int(rng.choice(POOL_SIZES)),
        activation=str(rng.choice(ACTIVATIONS)),
        optimizer=str(rng.choice(OPTIMIZERS)),
        dataset=str(rng.choice(DATASETS)),
        n_filters=int(rng.choice(N_FILTERS)),
        learning_rate=float(rng.choice(LEARNING_RATES)),
        padding=str(rng.choice(PADDING_MODES)),
        stride=int(rng.choice(STRIDES)),
        dropout=float(rng.choice(DROPOUTS)),
        n_devices=int(rng.choice(N_DEVICES)),
        batch_size=int(rng.choice(BATCH_SIZES)),
        strategy=str(rng.choice(DIST_STRATEGIES)),
        compression=str(rng.choice(GRAD_COMPRESSIONS)),
    )


def _sgd_step(params, grads, lr):
    return {k: p - lr * grads[k] for k, p in params.items()}


def _adam_step(params, grads, m, v, lr, t):
    m = {k: 0.9 * m[k] + 0.1 * g for k, g in grads.items()}
    v = {k: 0.999 * v[k] + 0.001 * g * g for k, g in grads.items()}
    params = {k: p - lr * (m[k] / (1 - 0.9 ** t)) /
              (torch.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
              for k, p in params.items()}
    return params, m, v


def make_iteration(cfg: LeNet5Config, mode: str):
    """One training iteration on the per-device sub-batch:
    ``(params, batch, rng) -> (new params, loss)``, where ``rng`` is the
    dropout draws (``models.lenet.dropout_noise``).

    A compiled mode first resets dynamo (``torch.compiler.reset``): dynamo
    keeps the graphs of one function's every config on its code object and
    refuses a fullgraph function past ``recompile_limit`` of them, so one
    compiled iteration is alive at a time."""

    def iteration(params, batch, rng):
        grads, loss = torch.func.grad_and_value(lenet_loss)(params, batch,
                                                            cfg, rng)
        if cfg.optimizer == "sgd":
            new_params = _sgd_step(params, grads, cfg.learning_rate)
        else:   # adam (stateless single-step approximation: t=1 moments)
            m0 = {k: torch.zeros_like(p) for k, p in params.items()}
            new_params, _, _ = _adam_step(params, grads, m0, m0,
                                          cfg.learning_rate, 1)
        return new_params, loss

    def iteration_in_place(params, batch, rng):
        new_params, loss = iteration(params, batch, rng)
        for k, p in params.items():
            p.copy_(new_params[k])
        return params, loss

    if mode == "eager":
        return iteration
    if mode not in ("jit", "jit_donate"):
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    torch.compiler.reset()
    fn = iteration if mode == "jit" else iteration_in_place
    return torch.compile(fn, fullgraph=True, dynamic=False)


@dataclass
class SweepRow:
    """The reference's row schema, field for field and in its order."""
    features: Dict
    mode: str
    measured_ms: float          # median single-device iteration time
    comm_ms: float              # cost-model simulated collective time
    time_ms: float              # measured + comm  (fit target)
    param_bytes: int
    # measured-vs-simulated pair: the schedule-priced total and the
    # wall-clock of a real sharded step over n_devices; when the measured
    # column is None, ``sharded_skip`` carries the reason sentinel.
    t_simulated: float = 0.0
    t_measured_sharded: Optional[float] = None
    sharded_skip: Optional[str] = None
    # provenance of the simulated columns: the link that priced the
    # schedule and the activation footprint tp-family schedules billed.
    calibration: str = "default"
    act_bytes: int = 0
    # which family produced the row and the fixed-work unit its fit
    # target normalizes by ("sample" for LeNet, "token" for LM rows).
    family: str = "lenet"
    norm_unit: str = "sample"


# ---------------------------------------------------------------------------
# The sharded probe
# ---------------------------------------------------------------------------

# The reference's layout of each LeNet leaf, as the port dim that each of its
# dims is: HWIO from OIHW for the convolutions, [in, out] from [out, in] for
# the dense layers.
_REFERENCE_DIMS = {4: (2, 3, 1, 0), 2: (1, 0)}


def _strategy_pspecs(params, strategy: str, axes_sizes: Dict[str, int]
                     ) -> Dict[str, Spec]:
    """Per-strategy specs of the LeNet params, in the port's layout: each
    mesh axis in the strategy's shard order goes to the first
    still-unassigned dimension it divides — walked in the *reference's*
    layout (HWIO conv, ``[in, out]`` dense), so every strategy shards the
    same dims, and moves the same bytes, as the reference's; the entries
    are then carried over to the port's dims.

    dp replicates; fsdp shards over "data"; tp over "model"; fsdp_tp
    assigns "data" then "model" to different divisible dims."""
    order = {"dp": (), "fsdp": ("data",), "tp": ("model",),
             "fsdp_tp": ("data", "model")}[strategy]
    out = {}
    for k, p in params.items():
        dims = _REFERENCE_DIMS[p.ndim]
        entries: List[Optional[str]] = [None] * p.ndim
        queue = [a for a in order if axes_sizes.get(a, 1) > 1]
        for i, d in enumerate(p.shape[j] for j in dims):
            if not queue:
                break
            a = queue[0]
            if d % axes_sizes[a] == 0 and d >= axes_sizes[a]:
                entries[dims[i]] = a
                queue.pop(0)
        out[k] = tuple(entries)
    return out


def lenet_partition_specs(cfg: LeNet5Config, params,
                          axes_sizes: Dict[str, int]):
    """(entry_specs, gather_specs, part_axes): how the sharded LeNet body
    holds each leaf on entry, which of that it gathers back in the body,
    and the ``LocalDim`` markers of the split fc pair (empty when the mesh
    has no model axis that divides 120). In the port's layout the split
    takes fc1's rows ``[120/m, flat]`` and fc2's columns ``[84, 120/m]``."""
    m = axes_sizes.get("model", 1)
    partition = (m > 1 and 120 % m == 0
                 and cfg.strategy in ("tp", "fsdp_tp"))
    # tp is dp plus the model split; fsdp_tp is fsdp plus it
    analog = ({"tp": "dp", "fsdp_tp": "fsdp"}[cfg.strategy]
              if partition else cfg.strategy)
    gather_specs = _strategy_pspecs(params, analog, axes_sizes)
    entry_specs = dict(gather_specs)
    part_axes: Dict[str, tuple] = {}
    if partition:
        col = LocalDim("mlp", "model", m)
        entry_specs["fc1"] = ("model", None)
        entry_specs["fc2"] = (None, "model")
        gather_specs["fc1"] = gather_specs["fc2"] = (None, None)
        part_axes = {"fc1": (col, None), "fc2": (None, col)}
    return entry_specs, gather_specs, part_axes


def make_sharded_iteration(cfg: LeNet5Config, mode: str, mesh: Mesh, params,
                           reset: bool = True):
    """One real distributed training iteration on this rank of ``mesh``:
    ``(local params, local batch, rng) -> (new local params, mean loss)``,
    with ``(iteration, entry_specs, batch_spec)`` returned; ``params`` are
    the full params (only their shapes are read).

    The body all-gathers the unsplit leaves (the parameter traffic the
    fsdp-family schedules charge for), keeps the split fc pair local
    (``lenet_loss`` with ``tp``: the model axis moves activation
    all-reduces), takes grads with ``torch.func.grad_and_value``, and
    reduces them through ``compressed_psum_mean``: split leaves over the
    data axes only (a pure tp mesh reduces nothing), every other leaf over
    all axes, after which ``shard_of_full`` takes this rank's block. Then
    the sgd or t = 1 adam step on the local blocks, and the loss averaged
    over all axes. Compiled modes are ``torch.compile(fullgraph=True,
    dynamic=False)`` of the whole body, collectives and codec kernels
    included; ``jit_donate`` writes the new blocks into the given ones.
    A compiled mode first resets dynamo (one compiled iteration alive, as
    a sweep holds); ``reset=False`` keeps the iterations compiled before
    alive, for a caller that holds several (``launch.plan``'s validation),
    which must then allow dynamo as many graphs of the body's code."""
    axis_names = mesh.axis_names
    entry_specs, gather_specs, part_axes = lenet_partition_specs(
        cfg, params, dict(mesh.shape))
    batch_spec: Spec = ("data",) if "data" in mesh.shape else ()
    data_axes = tuple(a for a in axis_names if a != "model")
    every = mesh.group(axis_names)
    data = mesh.group(data_axes) if data_axes else None
    tp = mesh.group("model") if part_axes else None

    def iteration(params, batch, rng):
        compute = {k: p if k in part_axes else
                   gather_to_full(p, gather_specs[k], mesh)
                   for k, p in params.items()}
        grads, loss = torch.func.grad_and_value(lenet_loss)(
            compute, batch, cfg, rng, tp)
        red = {}
        for k, g in grads.items():
            if k in part_axes:
                red[k] = (compressed_psum_mean(g, data, cfg.compression)
                          if data_axes else g)
            else:
                g = compressed_psum_mean(g, every, cfg.compression)
                red[k] = shard_of_full(g, gather_specs[k], mesh)
        if cfg.optimizer == "sgd":
            new_params = _sgd_step(params, red, cfg.learning_rate)
        else:
            m0 = {k: torch.zeros_like(p) for k, p in params.items()}
            new_params, _, _ = _adam_step(params, red, m0, m0,
                                          cfg.learning_rate, 1)
        loss = all_reduce(loss, "sum", every) / torch.full(
            (), float(mesh.size), device=loss.device)
        return new_params, loss

    def iteration_in_place(params, batch, rng):
        new_params, loss = iteration(params, batch, rng)
        for k, p in params.items():
            p.copy_(new_params[k])
        return params, loss

    if mode == "eager":
        return iteration, entry_specs, batch_spec
    if mode not in ("jit", "jit_donate"):
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if reset:
        torch.compiler.reset()
    fn = iteration if mode == "jit" else iteration_in_place
    return (torch.compile(fn, fullgraph=True, dynamic=False), entry_specs,
            batch_spec)


def sharded_inputs(cfg: LeNet5Config, mesh: Mesh, entry_specs, batch_spec,
                   params, batch, seed: int = 0):
    """This rank's (param blocks, batch block, dropout draws) of the full
    ``params`` and global ``batch``: blocks are copies, so a compiled
    ``jit_donate`` iteration may write into them."""
    local = {k: shard_of_full(p, entry_specs[k], mesh).clone()
             for k, p in params.items()}
    b = {k: shard_of_full(v, batch_spec, mesh).clone()
         for k, v in batch.items()}
    gen = torch.Generator(device=b["images"].device)
    gen.manual_seed(seed)
    rng = dropout_noise(gen, b["labels"].shape[0], local["fc1"].shape[0])
    return local, b, rng


def _time_sharded_iteration(ctx, cfg: LeNet5Config, mode: str, n_iters: int,
                            seed: int) -> List[float]:
    """Pool job: this rank's seconds of ``n_iters`` sharded iterations
    after a warm-up (the compile), each started at a barrier of the
    mesh's ranks and ended by a synchronise of the device."""
    mesh, dev = ctx.mesh, ctx.device
    params = init_lenet(cfg, seed=seed, device=dev)
    batch = lenet_batch(cfg, step=0, seed=seed, batch=cfg.batch_size,
                        device=dev)
    it, specs, batch_spec = make_sharded_iteration(cfg, mode, mesh, params)
    p, b, rng = sharded_inputs(cfg, mesh, specs, batch_spec, params, batch,
                               seed)
    p, _ = it(p, b, rng)                          # warm-up / compile
    sync(dev)
    every = mesh.group(mesh.axis_names)
    times = []
    for _ in range(n_iters):
        if every is not None:
            torch.distributed.barrier(group=every)
        t0 = time.perf_counter()
        p, loss = it(p, b, rng)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def measure_sharded_trial(cfg: LeNet5Config, mode: str, *, n_iters: int = 3,
                          seed: int = 0, pool=None
                          ) -> Tuple[Optional[float], Optional[str]]:
    """(median seconds of the sharded iteration over ``cfg.n_devices``
    ranks of ``pool``, skip sentinel): each iteration's time is its slowest
    rank's. ``(None, SKIP_POOL)`` without a pool or when the trial needs
    more ranks than the pool has. A rank that raises raises here
    (``RankError``)."""
    if pool is None or cfg.n_devices > pool.world:
        return None, SKIP_POOL
    per_rank = pool.run(_time_sharded_iteration, cfg, mode, n_iters, seed,
                        mesh=mesh_axes_for(cfg.strategy, cfg.n_devices))
    slowest = [max(ts[i] for ts in per_rank) for i in range(n_iters)]
    return float(statistics.median(slowest)), None


def measure_trial(cfg: LeNet5Config, mode: str, *, n_iters: int = 3,
                  seed: int = 0, sharded: bool = False,
                  calibration: Optional[Calibration] = None,
                  device="cuda", warmup_s: Optional[List[float]] = None,
                  pool=None) -> SweepRow:
    """Measure one config: a warm-up iteration (the compile, in a compiled
    mode), then the median of ``n_iters`` timed iterations, each from the
    previous one's parameters. ``warmup_s``, when given, gets the warm-up
    iteration's seconds appended. With ``sharded``, a compiled trial also
    measures the sharded iteration on ``pool`` (``measure_sharded_trial``)."""
    dev = resolve_device(device)
    cal = calibration if calibration is not None else load_calibration()
    params = init_lenet(cfg, seed=seed, device=dev)
    # Compute runs on the per-device sub-batch: the batch shards over the
    # data axis (and tp-family strategies split the compute m ways), so a
    # device performs ~batch/n of the per-iteration math for every strategy.
    per_dev = max(cfg.batch_size // max(cfg.n_devices, 1), 1)
    batch = lenet_batch(cfg, step=0, seed=seed, batch=per_dev, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = dropout_noise(gen, per_dev)    # one key for every iteration
    pb = sum(p.numel() * 4 for p in params.values())
    it = make_iteration(cfg, mode)

    p = params
    rec = current_recorder()
    with rec.span("compute_probe", category="sweep", mode=mode):
        sync(dev)
        t0 = time.perf_counter()
        p, _ = it(p, batch, rng)                  # warm-up / compile
        sync(dev)
        if warmup_s is not None:
            warmup_s.append(time.perf_counter() - t0)
        times = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            p, loss = it(p, batch, rng)
            sync(dev)
            times.append(time.perf_counter() - t0)
        measured = float(statistics.median(times))

    comm = comm_seconds(cfg, pb, calibration=cal)
    t_sim = measured * 1e3 + comm * 1e3
    t_meas, skip = None, SKIP_NOT_REQUESTED
    if sharded:
        if mode == "eager":
            skip = SKIP_EAGER
        else:
            with rec.span("sharded_probe", category="sweep", mode=mode):
                t_meas, skip = measure_sharded_trial(cfg, mode,
                                                     n_iters=n_iters,
                                                     seed=seed, pool=pool)
            if t_meas is not None:
                t_meas *= 1e3
    return SweepRow(features=lenet_features(cfg), mode=mode,
                    measured_ms=measured * 1e3, comm_ms=comm * 1e3,
                    time_ms=t_sim, param_bytes=pb, t_simulated=t_sim,
                    t_measured_sharded=t_meas, sharded_skip=skip,
                    calibration=cal.label, act_bytes=lenet_act_bytes(cfg))


def run_sweep(n_trials: int = 300, modes: Sequence[str] = MODES,
              seed: int = 0, out_path: Optional[str] = None,
              verbose_every: int = 50, sharded: bool = False,
              calibration: Optional[Calibration] = None, device="cuda",
              warmup_s: Optional[List[float]] = None,
              pool=None) -> List[Dict]:
    """``n_trials`` sampled configs, trial i in ``modes[i % len(modes)]``,
    measured on ``device``. A config that raises, on any rank of its
    sharded iteration too, is recorded as ``{"error", "mode", "features"}``
    and the sweep goes on. ``calibration`` prices every simulated column
    (None = the shared loaded one). ``sharded`` adds the measured column of
    the compiled trials, run on ``pool`` (None: every row ``SKIP_POOL``)."""
    dev = resolve_device(device)
    cal = calibration if calibration is not None else load_calibration()
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    t0 = time.time()
    rec = current_recorder()        # disabled default: spans are no-ops
    for i in range(n_trials):
        cfg = sample_config(rng)
        mode = modes[i % len(modes)]
        try:
            with rec.span("trial", category="sweep", index=i, mode=mode,
                          n_devices=cfg.n_devices,
                          strategy=str(cfg.strategy),
                          batch=cfg.batch_size):
                row = measure_trial(cfg, mode, seed=seed + i,
                                    sharded=sharded, calibration=cal,
                                    device=dev, warmup_s=warmup_s, pool=pool)
        except Exception as e:      # a pathological config; record & go on
            rows.append({"error": f"{type(e).__name__}: {e}", "mode": mode,
                         "features": lenet_features(cfg)})
            continue
        rows.append(asdict(row))
        if verbose_every and (i + 1) % verbose_every == 0:
            print(f"  sweep {i+1}/{n_trials} ({time.time()-t0:.0f}s)",
                  flush=True)
            if out_path:                       # incremental checkpoint
                _dump(rows, out_path)
    if out_path:
        _dump(rows, out_path)
    return rows


def _dump(rows: List[Dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(rows, f)


REF_SAMPLES = 128     # fixed work unit for sample-normalized rows (LeNet)
REF_TOKENS = 4096     # fixed work unit for token-normalized rows (seq models)


def fit_target_ms(row: Dict, source: str = "simulated") -> float:
    """Fit target: time to process a fixed unit of work at the sampled
    (batch, n_devices) — iteration time × (REF_SAMPLES / batch) for
    sample-normalized rows, × (REF_TOKENS / (batch × seq_len)) for
    token-normalized rows (``row["norm_unit"]``; absent = "sample").

    The paper's Table-6 finding is q_batch ≈ q_gpus ≈ −1, the signature
    of a fixed-work metric; raw per-iteration time of the sub-batch would
    leave almost no extrinsic signal.

    ``source`` picks the iteration time: "simulated" (per-device measured
    compute + schedule-priced comm), "measured" (the real sharded step —
    raises if the row has none), or "compute" (the compute time alone).
    """
    b = row["features"]["batch_size"]
    if source == "measured":
        t = row.get("t_measured_sharded")
        if t is None:
            raise ValueError("row has no t_measured_sharded "
                             "(sweep ran without a device pool?)")
    elif source == "simulated":
        t = row["measured_ms"] + row["comm_ms"]
    elif source == "compute":
        t = row["measured_ms"]
    else:
        raise ValueError(f"unknown fit-target source {source!r}")
    if row.get("norm_unit", "sample") == "token":
        return t * REF_TOKENS / (b * row["features"]["seq_len"])
    return t * REF_SAMPLES / b


def split_rows(rows: List[Dict], mode: str, n_fit: int = 900,
               source: str = "simulated"):
    """Paper split: 900 fit / 600 test (scaled to available rows)."""
    ok = [r for r in rows if "error" not in r and r["mode"] == mode]
    if source == "measured":
        ok = [r for r in ok if r.get("t_measured_sharded") is not None]
    k = min(n_fit, int(len(ok) * 0.6))
    fit, test = ok[:k], ok[k:]
    f_s = [r["features"] for r in fit]
    f_t = [r["features"] for r in test]
    return (f_s, [fit_target_ms(r, source) for r in fit],
            f_t, [fit_target_ms(r, source) for r in test])


# ---------------------------------------------------------------------------
# Cross-architecture sweep: lm / moe / ssm families
# ---------------------------------------------------------------------------
#
# The same measured-vs-simulated protocol as the LeNet sweep, with a
# family-preserving ``reduced()`` of a real architecture as the subject and
# the LM train step as the iteration: the compute probe is the compiled
# single-device step (``train.step.make_train_step(mode=...)``) on the
# per-device sub-batch, the sharded probe the compiled overlap body of
# ``make_sharded_train_step`` over ``n_devices`` ranks of a ``Pool``
# (registry-rule parameter shards, per-layer gathers and Megatron splits,
# the wire-compressed gradient reduction). Intrinsics per family come from
# the ``perf.features`` registry; extrinsics are shared with LeNet. A row
# labelled "jit" or "jit_donate" was timed on a step that compiled with
# ``fullgraph=True``: a point that does not compile raises there, and the
# sweep records it as an error row with dynamo's reason.

ARCH_N_DEVICES = (1, 2, 4, 8)
ARCH_BATCH_SIZES = (8, 16, 32)
# wire formats the sharded LM step implements (``tcfg.grad_compression``):
# int8 rides through the error-feedback collective on this path.
ARCH_COMPRESSIONS = ("none", "bf16", "int8_ef")


@dataclass(frozen=True)
class ArchPoint:
    """One sampled cross-architecture trial (the reference's, field for
    field). Intrinsics a family does not use stay 0 and are absent from
    that family's FeatureSpec."""
    family: str
    arch_id: str
    seq_len: int
    d_model: int
    n_layers: int
    d_ff: int = 0
    n_experts: int = 0
    top_k: int = 0
    d_state: int = 0
    n_devices: int = 1
    batch_size: int = 8
    strategy: str = "dp"
    compression: str = "none"

    @property
    def wire_bits(self) -> int:
        return WIRE_BITS[self.compression]

    def model_config(self):
        """The family-preserving ``reduced()`` ModelConfig this point
        trains; intrinsics the reducer pins (MoE top_k, SSD state dim)
        are re-opened so the sweep actually varies them."""
        import dataclasses

        from repro_torch.configs import get_config, reduced

        cfg = reduced(get_config(self.arch_id), n_layers=self.n_layers,
                      d_model=self.d_model, vocab=256,
                      d_ff=self.d_ff or 128,
                      n_experts=self.n_experts or 4,
                      seq_cap=self.seq_len)
        if self.top_k and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, top_k=min(self.top_k, cfg.moe.n_experts)))
        if self.d_state and cfg.ssm is not None:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, d_state=self.d_state))
        return cfg

    def features(self) -> Dict:
        return get_spec(self.family).features(self)


def sample_arch_point(family: str, rng: np.random.Generator) -> ArchPoint:
    """Random point of ``family``'s intrinsic space × the shared extrinsic
    grid: the reference's draws in the reference's order."""
    aspec = get_spec(family)
    intr = {k: int(rng.choice(v)) for k, v in aspec.intrinsic_space.items()}
    return ArchPoint(family=family, arch_id=aspec.arch_id,
                     n_devices=int(rng.choice(ARCH_N_DEVICES)),
                     batch_size=int(rng.choice(ARCH_BATCH_SIZES)),
                     strategy=str(rng.choice(DIST_STRATEGIES)),
                     compression=str(rng.choice(ARCH_COMPRESSIONS)),
                     **intr)


def arch_mesh_axes(strategy: str, n_devices: int) -> Dict[str, int]:
    """``mesh_axes_for`` plus a size-1 "data" axis when the strategy has
    none: the LM sharded train step reduces gradients over the batch axes
    and refuses a mesh without one, so tp meshes replicate the batch over
    a degenerate data axis."""
    axes = dict(mesh_axes_for(strategy, n_devices))
    if "data" not in axes:
        axes = {"data": 1, **axes}
    return axes


def arch_train_config(compression: str = "none"):
    """The arch sweep's TrainConfig (the reference's): sgd, no remat, the
    wire format ``compression`` (the compute probe's is "none": it is wire
    format, not compute)."""
    from repro_torch.configs import TrainConfig
    return TrainConfig(optimizer="sgd", grad_compression=compression,
                       remat_policy="none")


def _eager_steps(step, state, batch, steps: int):
    """``steps`` steps of ``step`` from ``state`` on ``batch``: (the losses,
    fp32 copies of the parameter leaves after the last)."""
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, [t.detach().float().clone() for t in tree_leaves(state.params)]


def param_gap(ref, params) -> float:
    """The largest |difference| between the leaves ``ref`` (``_eager_steps``)
    and ``params``'s, each leaf's relative to its largest |value| in
    ``ref``."""
    return max(float((a - b.float()).abs().max() / a.abs().max().clamp_min(1e-30))
               for a, b in zip(ref, tree_leaves(params)))


def _time_sharded_arch_step(ctx, point: ArchPoint, mode: str, n_iters: int,
                            seed: int, eager_check: bool = False) -> Dict:
    """Pool job: this rank's seconds of the warm-up (the compile) and of
    ``n_iters`` compiled overlap steps of ``point``, each started at a
    barrier of the mesh's ranks and ended by a synchronise of the device;
    the losses, the kernel launches per timed step (``launches_per_step``)
    and dynamo's graph breaks and graphs. With ``eager_check``, first as
    many eager overlap steps from the same init ("eager_losses"), and the
    parameter slices' ``param_gap`` after the last of each ("param_gap")."""
    from torch._dynamo.utils import counters

    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.dist.probes import launch_snapshot
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.train.step import (init_sharded_train_state,
                                        make_sharded_train_step)

    mesh, dev = ctx.mesh, ctx.device
    cfg, tcfg = point.model_config(), arch_train_config(point.compression)
    batch = batch_shardings(make_batch_for(cfg, point.batch_size,
                                           point.seq_len, seed=seed), mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}

    def init():
        return init_sharded_train_state(cfg, tcfg, mesh, point.strategy,
                                        seed=seed, device=dev)

    out = {}
    if eager_check:
        step = make_sharded_train_step(cfg, tcfg, mesh, point.strategy,
                                       overlap=True)
        out["eager_losses"], ref = _eager_steps(step, init(), batch, 1 + n_iters)
    torch.compiler.reset()          # one compiled step alive (make_iteration)
    counters.clear()
    state = init()
    step = make_sharded_train_step(cfg, tcfg, mesh, point.strategy,
                                   overlap=True, mode=mode)
    every = mesh.group(mesh.axis_names)
    sync(dev)
    t0 = time.perf_counter()
    state, m = step(state, batch)                 # warm-up / compile
    sync(dev)
    warmup = time.perf_counter() - t0
    losses, times = [float(m["loss"])], []
    before = launch_snapshot()
    for _ in range(n_iters):
        if every is not None:
            torch.distributed.barrier(group=every)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    out.update(times=times, warmup_s=warmup, losses=losses,
               launches=launches_per_step(before, n_iters),
               graph_breaks=sum(counters["graph_break"].values()),
               graphs=counters["stats"]["unique_graphs"])
    if eager_check:
        out["param_gap"] = param_gap(ref, state.params)
    return out


def launches_per_step(before: Dict, steps: int) -> Dict:
    """Each kernel's launches since ``before`` (``probes.launch_snapshot``)
    per step of ``steps``, flash attention's and the SSD scan's by design
    too."""
    from repro_torch.dist.probes import launch_snapshot
    now = launch_snapshot()
    return {k: (now[k] - before[k]) / steps if isinstance(now[k], int) else
            {d: (now[k][d] - before[k][d]) / steps for d in now[k]}
            for k in now}


def measure_sharded_arch_trial(point: ArchPoint, mode: str, *,
                               n_iters: int = 2, seed: int = 0, pool=None,
                               extra: Optional[Dict] = None,
                               eager_check: bool = False
                               ) -> Tuple[Optional[float], Optional[str]]:
    """(median seconds of the compiled overlap step over
    ``point.n_devices`` ranks of ``pool``, skip sentinel): each step's time
    is its slowest rank's. ``(None, SKIP_POOL)`` without a pool or when
    the point needs more ranks than it has. ``extra``, when given, gets
    each rank's job result under "sharded". A rank that raises raises here
    (``RankError``)."""
    if pool is None or point.n_devices > pool.world:
        return None, SKIP_POOL
    per_rank = pool.run(_time_sharded_arch_step, point, mode, n_iters, seed,
                        eager_check,
                        mesh=arch_mesh_axes(point.strategy, point.n_devices))
    if extra is not None:
        extra["sharded"] = per_rank
    slowest = [max(r["times"][i] for r in per_rank) for i in range(n_iters)]
    return float(statistics.median(slowest)), None


def measure_arch_trial(point: ArchPoint, mode: str = "jit", *,
                       n_iters: int = 2, seed: int = 0, sharded: bool = True,
                       calibration: Optional[Calibration] = None,
                       device="cuda", pool=None,
                       extra: Optional[Dict] = None,
                       eager_check: bool = False) -> SweepRow:
    """The cross-architecture counterpart of ``measure_trial``: the same
    row schema, the token norm unit, the LM train step as the subject.
    ``mode`` is "jit" or "jit_donate" (the compiled steps,
    ``train.step.compile_fullgraph``) or "eager".
    ``extra``, when given, gets the compute probe's warm-up seconds
    ("compile_s"), its losses, launches per timed step and graph breaks
    and graphs, and the sharded job's results ("sharded"); with
    ``eager_check`` also the losses of as many eager steps from the same
    init ("eager_losses") and the two parameter trees' ``param_gap`` after
    the last ("param_gap"), on one device and on the ranks."""
    from torch._dynamo.utils import counters

    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.dist.probes import launch_snapshot
    from repro_torch.perf.planner.space import model_comm_sizes
    from repro_torch.perf.predict import estimate_comm
    from repro_torch.train.step import init_train_state, make_train_step

    dev = resolve_device(device)
    cal = calibration if calibration is not None else load_calibration()
    cfg = point.model_config()
    # Single-device compute on the compute-equivalent sub-batch: the
    # overlap step partitions tensor-parallel compute over "model", so a
    # device performs ~batch/n of the math for every strategy.
    tc_comp = arch_train_config()
    per_dev = max(point.batch_size // max(point.n_devices, 1), 1)
    batch = {k: v.to(dev) for k, v in
             make_batch_for(cfg, per_dev, point.seq_len, seed=seed).items()}
    eager_check = eager_check and extra is not None
    if eager_check:
        extra["eager_losses"], ref = _eager_steps(
            make_train_step(cfg, tc_comp),
            init_train_state(cfg, tc_comp, seed=seed, device=dev), batch,
            1 + n_iters)
    torch.compiler.reset()
    counters.clear()
    state = init_train_state(cfg, tc_comp, seed=seed, device=dev)
    step = make_train_step(cfg, tc_comp, mode=mode)
    rec = current_recorder()
    with rec.span("compute_probe", category="sweep", mode=mode):
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)             # warm-up / compile
        sync(dev)
        warmup = time.perf_counter() - t0
        losses, times = [float(m["loss"])], []
        before = launch_snapshot()
        for _ in range(n_iters):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync(dev)
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        measured = float(statistics.median(times))
    if extra is not None:
        extra.update(compile_s=warmup, losses=losses,
                     launches=launches_per_step(before, n_iters),
                     graph_breaks=sum(counters["graph_break"].values()),
                     graphs=counters["stats"]["unique_graphs"])
    if eager_check:
        extra["param_gap"] = param_gap(ref, state.params)

    pb, ab = model_comm_sizes(cfg, point.batch_size, point.seq_len)
    comm = estimate_comm(point.strategy, point.n_devices, pb,
                         wire_bits=point.wire_bits, act_bytes=ab,
                         calibration=cal).seconds
    t_sim = measured * 1e3 + comm * 1e3
    t_meas, skip = None, SKIP_NOT_REQUESTED
    if sharded:
        if mode == "eager":
            skip = SKIP_EAGER
        else:
            with rec.span("sharded_probe", category="sweep", mode=mode):
                t_meas, skip = measure_sharded_arch_trial(
                    point, mode, n_iters=n_iters, seed=seed, pool=pool,
                    extra=extra, eager_check=eager_check)
            if t_meas is not None:
                t_meas *= 1e3
    return SweepRow(features=point.features(), mode=mode,
                    measured_ms=measured * 1e3, comm_ms=comm * 1e3,
                    time_ms=t_sim, param_bytes=pb, t_simulated=t_sim,
                    t_measured_sharded=t_meas, sharded_skip=skip,
                    calibration=cal.label, act_bytes=ab, family=point.family,
                    norm_unit=get_spec(point.family).norm_unit)


def run_arch_sweep(family: str, n_trials: int = 48, mode: str = "jit",
                   seed: int = 0, out_path: Optional[str] = None,
                   verbose_every: int = 5, sharded: bool = True,
                   calibration: Optional[Calibration] = None,
                   n_iters: int = 2, device="cuda", pool=None) -> List[Dict]:
    """Random sweep of one architecture family (``run_sweep``'s
    counterpart; one mode, "jit" by default). A point that raises, on any
    rank too, or that does not compile in one graph, is recorded as
    ``{"error", "mode", "family", "features"}`` and the sweep goes on."""
    dev = resolve_device(device)
    cal = calibration if calibration is not None else load_calibration()
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    t0 = time.time()
    rec = current_recorder()        # disabled default: spans are no-ops
    for i in range(n_trials):
        point = sample_arch_point(family, rng)
        try:
            with rec.span("trial", category="sweep", index=i,
                          family=family, mode=mode,
                          n_devices=point.n_devices,
                          strategy=str(point.strategy),
                          batch=point.batch_size):
                row = measure_arch_trial(point, mode, n_iters=n_iters,
                                         seed=seed + i, sharded=sharded,
                                         calibration=cal, device=dev,
                                         pool=pool)
        except Exception as e:      # a pathological point; record & go on
            rows.append({"error": f"{type(e).__name__}: {e}", "mode": mode,
                         "family": family, "features": point.features()})
            continue
        rows.append(asdict(row))
        if verbose_every and (i + 1) % verbose_every == 0:
            print(f"  [{family}] sweep {i+1}/{n_trials} "
                  f"({time.time()-t0:.0f}s)", flush=True)
            if out_path:                       # incremental checkpoint
                _dump(rows, out_path)
    if out_path:
        _dump(rows, out_path)
    return rows
