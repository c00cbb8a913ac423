"""The paper's measured-time experiment: the LeNet-5 hyperparameter sweep,
single-device half (``repro.perf.sweep``'s LeNet path).

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

The sharded probe (``sharded=True``: a real multi-device iteration beside
the simulated one) is not ported yet and raises.
"""
from __future__ import annotations

import json
import statistics
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence

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
from repro_torch.dist.compression import WIRE_BITS
from repro_torch.launch.serve import sync
from repro_torch.models.lenet import (dropout_noise, feature_dims, init_lenet,
                                      lenet_loss)
from repro_torch.perf.costmodel import Calibration, load_calibration
from repro_torch.perf.features import lenet_features

MODES = ("jit", "jit_donate", "eager")

# Sentinels recorded in ``SweepRow.sharded_skip`` when the measured
# column is None (the reference's row schema).
SKIP_EAGER = "eager-mode"            # op-by-op dispatch measures python, not comm
SKIP_POOL = "pool-too-small"         # host pool < n_devices
SKIP_NOT_REQUESTED = "not-requested"  # sharded=False sweep

SHARDED_NOT_PORTED = ("the sharded probe is not ported yet: it is slice 7 of "
                      "the port (ROADMAP A4/A5)")


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


def measure_trial(cfg: LeNet5Config, mode: str, *, n_iters: int = 3,
                  seed: int = 0, sharded: bool = False,
                  calibration: Optional[Calibration] = None,
                  device="cuda",
                  warmup_s: Optional[List[float]] = None) -> SweepRow:
    """Measure one config: a warm-up iteration (the compile, in a compiled
    mode), then the median of ``n_iters`` timed iterations, each from the
    previous one's parameters. ``warmup_s``, when given, gets the warm-up
    iteration's seconds appended."""
    if sharded:
        raise NotImplementedError(SHARDED_NOT_PORTED)
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
    sync(dev)
    t0 = time.perf_counter()
    p, _ = it(p, batch, rng)                      # warm-up / compile
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
    return SweepRow(features=lenet_features(cfg), mode=mode,
                    measured_ms=measured * 1e3, comm_ms=comm * 1e3,
                    time_ms=t_sim, param_bytes=pb, t_simulated=t_sim,
                    t_measured_sharded=None, sharded_skip=SKIP_NOT_REQUESTED,
                    calibration=cal.label, act_bytes=lenet_act_bytes(cfg))


def run_sweep(n_trials: int = 300, modes: Sequence[str] = MODES,
              seed: int = 0, out_path: Optional[str] = None,
              verbose_every: int = 50, sharded: bool = False,
              calibration: Optional[Calibration] = None, device="cuda",
              warmup_s: Optional[List[float]] = None) -> List[Dict]:
    """``n_trials`` sampled configs, trial i in ``modes[i % len(modes)]``,
    measured on ``device``. A config that raises is recorded as
    ``{"error", "mode", "features"}`` and the sweep goes on. ``calibration``
    prices every simulated column (None = the shared loaded one)."""
    if sharded:
        raise NotImplementedError(SHARDED_NOT_PORTED)
    dev = resolve_device(device)
    cal = calibration if calibration is not None else load_calibration()
    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    t0 = time.time()
    for i in range(n_trials):
        cfg = sample_config(rng)
        mode = modes[i % len(modes)]
        try:
            row = measure_trial(cfg, mode, seed=seed + i, calibration=cal,
                                device=dev, warmup_s=warmup_s)
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
