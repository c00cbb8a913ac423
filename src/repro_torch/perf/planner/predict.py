"""Vectorized time/throughput/efficiency predictions per launch point
(``repro.perf.planner.predict``).

The prediction inverts the fitted model structurally instead of letting it
extrapolate the device axis:

    t̂_step(point) = t̂_compute(sub-batch) · oversub(n) + t_comm(point)

* ``t̂_compute(sub-batch)`` — the generic performance model fitted on the
  sweep's **compute-only** target (``fit_target_ms(row, "compute")``),
  queried at one device and the point's per-rank sub-batch, the regime the
  sweep measured, in one pass through ``perf.predict.predict_samples``;
* ``oversub(n) = max(1, n/k)`` — the pool's oversubscription law. The
  reference's host pool timeshares its cores; the port's ranks share one
  card (and its host's cores), so their computations serialise the same
  way. ``k``, the effective parallel width, is fitted from the measured
  rows. A tp-family rank touches ~1/|model| of a layer's FLOPs, so the
  sub-batch divides by all ranks for every strategy;
* ``t_comm`` — the strategy's collective schedule (``perf.costmodel``)
  priced by a link fitted on the residual after oversubscription (the
  shared link would count the serialisation twice); only the exposed part
  ``max(0, comm − ρ·compute)`` lands on the clock, with a per-strategy ρ
  fitted jointly with the link.

The terms stay separate so ``report.py`` can say which dominates, and the
band is this predictor's MAPE against the measured sharded times of the
calibration rows. Times are in the sweep's fixed-work unit (ms to process
``REF_SAMPLES`` samples, or ``REF_TOKENS`` tokens), so points with
different batches compare; ``step_ms`` is one iteration of the point's own
global batch.

The compute model evaluates on a device (``PerfModel.device``): ``load``
and ``fit_planner_model`` take it, "cuda" unless the caller says "cpu".
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.generic_model import PerfModel
from repro_torch.perf.costmodel import Calibration, load_calibration
from repro_torch.perf.features import get_spec, spec_for_tag
from repro_torch.perf.planner.space import Feasibility, LaunchPoint
from repro_torch.perf.predict import CommEstimate, estimate_comm, predict_samples

MODEL_SCHEMA_VERSION = 2

UNCALIBRATED_NOTE = "uncalibrated α-β defaults in use"

# Candidate effective-parallel-widths for the oversubscription fit.
OVERSUB_GRID = (0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0)


def default_model_path() -> str:
    """The checked-in model, fitted from the reference's measured sweep
    (read only: the port writes a model where it is told)."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))
    return os.path.join(repo, "benchmarks", "artifacts",
                        "planner_model.json")


@dataclass
class PlannerModel:
    """Everything the planner predicts with, persistable as one JSON."""
    compute: PerfModel
    compute_mape: float             # held-out MAPE of the compute fit
    oversub_k: float = 1.0          # effective parallel width of the pool
    calibration: Calibration = field(default_factory=load_calibration)
    band_mape: float = 0.0          # this predictor vs measured sharded
    meta: Dict = field(default_factory=dict)
    # which feature spec shaped the constant vector — resolved back
    # through the per-architecture registry on load, so one PlannerModel
    # class serves every family (repro.perf.features.spec_for_tag).
    spec_tag: str = "lenet-table1-v1"

    @property
    def calibrated(self) -> bool:
        return self.calibration.label != "default"

    def calibration_note(self) -> str:
        return (f"calibration: {self.calibration.label}" if self.calibrated
                else f"calibration: {UNCALIBRATED_NOTE}")

    def oversub(self, n_devices: int) -> float:
        return max(1.0, n_devices / self.oversub_k)

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict:
        return {"version": MODEL_SCHEMA_VERSION,
                "spec": self.spec_tag,
                "x": np.asarray(self.compute.x, float).tolist(),
                "x_seeds": (None if self.compute.x_seeds is None else
                            np.asarray(self.compute.x_seeds,
                                       float).tolist()),
                "compute_mape": float(self.compute_mape),
                "oversub_k": float(self.oversub_k),
                "calibration": self.calibration.to_dict(),
                "band_mape": float(self.band_mape),
                "meta": dict(self.meta)}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def from_dict(cls, d: Mapping, device="cuda") -> "PlannerModel":
        if int(d.get("version", 0)) != MODEL_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported planner-model schema version "
                f"{d.get('version')!r} (want {MODEL_SCHEMA_VERSION}) — "
                f"refit with `python -m repro_torch.launch.plan --refit`")
        tag = str(d.get("spec", "lenet-table1-v1"))
        spec = spec_for_tag(tag).spec          # KeyError on unknown tags
        x = np.asarray(d["x"], float)
        if len(x) != spec.n_params:
            raise ValueError(
                f"planner model has {len(x)} constants but spec "
                f"{tag!r} needs {spec.n_params} — refit with "
                f"`python -m repro_torch.launch.plan --refit`")
        xs = d.get("x_seeds")
        model = PerfModel(spec, x,
                          x_seeds=None if xs is None else np.asarray(xs),
                          device=str(resolve_device(device)))
        cal = (Calibration.from_dict(d["calibration"])
               if d.get("calibration") else load_calibration())
        return cls(compute=model, compute_mape=float(d["compute_mape"]),
                   oversub_k=float(d.get("oversub_k", 1.0)),
                   calibration=cal,
                   band_mape=float(d.get("band_mape", 0.0)),
                   meta=dict(d.get("meta", {})), spec_tag=tag)

    @classmethod
    def load(cls, path: Optional[str] = None, device="cuda") -> "PlannerModel":
        path = path or default_model_path()
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"planner model artifact {path!r} missing — fit one with "
                f"`PYTHONPATH=src python -m repro_torch.launch.plan --refit "
                f"--rows ROWS --model-out PATH` (rows from `python -m "
                f"repro_torch.launch.fit_perfmodel --sharded --rows-out`)")
        with open(path) as f:
            return cls.from_dict(json.load(f), device=device)


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------

def _sub_batch(strategy: str, n_devices: int, batch: int) -> int:
    """Per-device compute-equivalent batch: divides by *all* devices.

    The batch itself shards only over the data axis, but the overlap
    step partitions tensor-parallel compute Megatron-style, so a model
    rank performs ~1/|model| of the per-layer FLOPs on its (replicated)
    batch slice. batch/(data·model) = batch/n is the compute-equivalent
    sub-batch the fitted single-device model is queried at — for
    dp/fsdp (model = 1) this is the plain per-device batch, exactly as
    before."""
    return max(batch // max(n_devices, 1), 1)


def _compute_samples(feature_rows: Sequence[Mapping]) -> List[Dict]:
    """Feature dicts re-anchored to the measured regime: one device, the
    per-device sub-batch. The fitted powers then only *interpolate* the
    batch axis; the device axis is handled structurally by oversub()."""
    out = []
    for f in feature_rows:
        g = dict(f)
        g["batch_size"] = _sub_batch(f["strategy"], int(f["n_devices"]),
                                     int(f["batch_size"]))
        g["n_devices"] = 1
        out.append(g)
    return out


def _ref_work_scale(spec_tag: str,
                    feature_rows: Sequence[Mapping]) -> np.ndarray:
    """Per-row fraction of the fixed work unit one iteration performs —
    batch/REF_SAMPLES for sample-normalized specs, batch·seq/REF_TOKENS
    for token-normalized ones (the spec's ``norm_unit``)."""
    from repro_torch.perf.sweep import REF_SAMPLES, REF_TOKENS

    b = np.array([float(f["batch_size"]) for f in feature_rows])
    if spec_for_tag(spec_tag).norm_unit == "token":
        seq = np.array([float(f["seq_len"]) for f in feature_rows])
        return b * seq / REF_TOKENS
    return b / REF_SAMPLES


def _predict_step_ms(model: "PlannerModel",
                     feature_rows: Sequence[Mapping],
                     comm_step_ms: np.ndarray,
                     strategies: Optional[Sequence[str]] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(compute_step_ms, total_step_ms, exposed_comm_ms) per feature row.

    Only the exposed communication ``max(0, comm − ρ·compute)`` enters
    the total; ρ comes from the planner calibration's fitted overlap
    map (0 when unfitted, restoring the fully-serialized sum).
    ``strategies`` defaults to each row's own ``strategy`` feature.
    """
    samples = _compute_samples(feature_rows)
    comp_fw_sub = np.asarray(predict_samples(model.compute, samples), float)
    over = np.array([model.oversub(int(f["n_devices"]))
                     for f in feature_rows])
    comp_step = comp_fw_sub * _ref_work_scale(model.spec_tag, samples) * over
    if strategies is None:
        strategies = [f.get("strategy") for f in feature_rows]
    rho = np.array([0.0 if s is None else model.calibration.overlap_for(s)
                    for s in strategies])
    exposed = np.maximum(np.asarray(comm_step_ms, float) - rho * comp_step,
                         0.0)
    return comp_step, comp_step + exposed, exposed


def _fit_decomposition(rows: Sequence[Mapping], *,
                       seeds: Sequence[int], maxiter: int, device="cuda"
                       ) -> Tuple[float, Calibration, Dict]:
    """Fit (oversub_k, planner link, overlap ρ) on the measured rows.

    For each candidate width the residual after oversubscribed compute,
    ``t_measured − measured_ms · max(1, n/k)``, is fitted by one shared
    ring link plus a per-strategy overlap factor ρ that lets up to
    ``ρ·compute`` of the schedule hide behind the overlapped step
    (same DE machinery as the global calibration); the lowest-MAE
    (k, link, ρ) triple wins. ρ multiplies the *oversubscribed* compute
    because that is the wall clock the streamed gathers run alongside on
    the shared pool (the reference's host cores; the port's card).
    """
    from repro_torch.perf.costmodel.calibrate import (_fit_links_overlap,
                                                      calibration_rows,
                                                      overlap_matrices,
                                                      residual_matrices)
    from repro_torch.perf.costmodel.primitives import COLLECTIVES

    ok = calibration_rows(rows)
    if not ok:
        raise ValueError("no rows with measured sharded times above one "
                         "device — measure them with `python -m repro_torch."
                         "launch.fit_perfmodel --sharded --rows-out`")
    H, V, _ = residual_matrices(ok)
    Hs, Vs = H.sum(1, keepdims=True), V.sum(1, keepdims=True)
    _, S, strategies = overlap_matrices(ok)
    meas = np.array([r["t_measured_sharded"] for r in ok]) * 1e-3
    comp = np.array([r["measured_ms"] for r in ok]) * 1e-3
    n = np.array([int(r["features"]["n_devices"]) for r in ok], float)

    # relative objective: dividing each row's coefficients and residual
    # by its measured time keeps the problem linear in (α, 1/bw, ρ)
    # while the DE cost becomes mean |relative error| — the statistic
    # the planner reports — instead of letting the slowest rows
    # dominate. relu(w·z) = w·relu(z) for w > 0, so scaling the
    # exposed-comm hinge by w preserves the relative objective.
    w = 1.0 / np.maximum(meas, 1e-9)
    best = None
    for k in OVERSUB_GRID:
        comp_over = comp * np.maximum(1.0, n / k)
        y = (meas - comp_over) * w
        links, rho, rel_mae = _fit_links_overlap(
            Hs * w[:, None], Vs * w[:, None], y, [COLLECTIVES[0]],
            comp_over * w, S, strategies, seeds=seeds, maxiter=maxiter,
            device=device)
        if best is None or rel_mae < best[0]:
            best = (rel_mae, k, links[COLLECTIVES[0]], rho)
    rel_mae, k, link, rho = best
    meta = {"n_rows": len(ok), "oversub_grid": list(OVERSUB_GRID),
            "objective": "relative", "rel_mae_fitted": rel_mae,
            "overlap": dict(rho)}
    cal = Calibration(label=f"planner:oversub-k={k:g}+overlap",
                      default=link, overlap=dict(rho), meta=meta)
    return k, cal, meta


def evaluate_on_rows(model: "PlannerModel",
                     rows: Sequence[Mapping]) -> Dict[str, float]:
    """MAPE/bias of the full predictor against the measured sharded
    column of ``rows``: the statistic the uncertainty band carries."""
    from repro_torch.perf.costmodel.calibrate import (calibration_rows,
                                                      row_inputs)
    from repro_torch.perf.costmodel import strategy_comm_seconds

    ok = calibration_rows(rows)
    if not ok:
        return {"n": 0, "mape": 0.0, "bias": 0.0}
    links = model.calibration.links()
    comm = np.array([strategy_comm_seconds(r["features"]["strategy"],
                                           row_inputs(r), links) * 1e3
                     for r in ok])
    _, pred, _ = _predict_step_ms(model, [r["features"] for r in ok], comm)
    meas = np.array([r["t_measured_sharded"] for r in ok])
    rel = (pred - meas) / np.maximum(np.abs(meas), 1e-9)
    return {"n": len(ok), "mape": float(np.mean(np.abs(rel))),
            "bias": float(np.mean(rel))}


def fit_planner_model(rows: Sequence[Dict], *, mode: str = "jit",
                      seeds: Sequence[int] = tuple(range(4)),
                      maxiter: int = 300, source: str = "",
                      family: str = "lenet", device="cuda") -> PlannerModel:
    """Fit compute model + oversubscription decomposition from sweep rows
    of one architecture ``family`` (its registry spec shapes the fit); the
    DE fits run on ``device``, where the model then predicts."""
    from repro_torch.core.fit import fit_sweep_rows

    aspec = get_spec(family)
    r, n_fit, n_test = fit_sweep_rows(aspec.spec, rows, mode, "compute",
                                      seeds=tuple(seeds), maxiter=maxiter,
                                      device=device)
    k, cal, decomp_meta = _fit_decomposition(rows, seeds=seeds,
                                             maxiter=maxiter, device=device)
    meta = {"target": "compute", "mode": mode, "n_fit": n_fit,
            "n_test": n_test, "seeds": list(seeds), "maxiter": int(maxiter),
            "source": source, "test_metrics": r.test_metrics,
            "family": family, "decomposition": decomp_meta}
    model = PlannerModel(compute=r.model,
                         compute_mape=float(r.test_metrics["mape"]),
                         oversub_k=k, calibration=cal, meta=meta,
                         spec_tag=aspec.spec_tag)
    ev = evaluate_on_rows(model, rows)
    model.band_mape = ev["mape"]
    model.meta["eval_vs_measured"] = ev
    return model


# ---------------------------------------------------------------------------
# Per-point predictions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Prediction:
    """One launch point with its predicted operating characteristics.

    Times are fixed-work milliseconds (``REF_SAMPLES`` samples);
    ``device_seconds`` is the device-time budget the point burns per
    fixed-work unit; ``mem_headroom_bytes`` is against the planning
    budget the space was enumerated with.
    """
    point: LaunchPoint
    feasibility: Feasibility
    compute_ms: float
    comm_ms: float
    time_ms: float
    lo_ms: float
    hi_ms: float
    step_ms: float
    throughput_sps: float        # samples / second
    efficiency_sps_per_device: float
    device_seconds: float
    mem_headroom_bytes: int
    dominant_term: str           # "compute" or "comm:<op>@<axis>"
    comm: CommEstimate

    def to_dict(self) -> Dict:
        return {"strategy": self.point.strategy,
                "n_devices": self.point.n_devices,
                "batch_size": self.point.batch_size,
                "compression": self.point.compression,
                "compute_ms": self.compute_ms, "comm_ms": self.comm_ms,
                "time_ms": self.time_ms,
                "band_ms": [self.lo_ms, self.hi_ms],
                "step_ms": self.step_ms,
                "throughput_sps": self.throughput_sps,
                "efficiency_sps_per_device":
                    self.efficiency_sps_per_device,
                "device_seconds": self.device_seconds,
                "mem_headroom_bytes": self.mem_headroom_bytes,
                "dominant_term": self.dominant_term,
                "memory": self.feasibility.memory.to_dict()}


def _dominant_term(compute_ms: float, comm: CommEstimate,
                   exposed_ms: float) -> str:
    """Compare compute against the *exposed* comm — hidden comm can't
    dominate a recommendation no matter how large the raw schedule is."""
    if exposed_ms <= compute_ms or not comm.schedule:
        return "compute"
    top = max(comm.schedule, key=lambda c: c["ms"])
    return f"comm:{top['op']}@{top['axis']}"


def predict_points(model: PlannerModel,
                   points: Sequence[Tuple[LaunchPoint, Feasibility]]
                   ) -> List[Prediction]:
    """Vectorized predictions for (point, feasibility) pairs.

    One encode/predict pass covers every point's compute term; the comm
    term is priced per point from its own schedule under the planner's
    decomposition calibration. The band is ``±band_mape`` — the MAPE of
    this exact predictor against the measured sharded rows.
    """
    from repro_torch.perf.sweep import REF_SAMPLES, REF_TOKENS

    if not points:
        return []
    aspec = spec_for_tag(model.spec_tag)
    # LeNet's extractor reads the LeNet5Config; the seq extractors read
    # the point itself (ArchLaunchPoint exposes the intrinsic surface).
    feature_rows = [aspec.features(p.cfg if aspec.family == "lenet" else p)
                    for p, _ in points]
    comms: List[CommEstimate] = []
    for point, feas in points:
        comms.append(estimate_comm(
            point.strategy, point.n_devices,
            feas.memory.params_full_bytes, wire_bits=point.wire_bits,
            act_bytes=point.act_bytes(),
            calibration=model.calibration, detail=True))
    comm_step = np.array([c.seconds * 1e3 for c in comms])
    comp_step, total_step, exposed_step = _predict_step_ms(
        model, feature_rows, comm_step,
        strategies=[p.strategy for p, _ in points])
    scales = 1.0 / _ref_work_scale(model.spec_tag, feature_rows)
    ref_units = REF_TOKENS if aspec.norm_unit == "token" else REF_SAMPLES

    band = max(model.band_mape, model.compute_mape, 1e-6)
    out: List[Prediction] = []
    for i, (point, feas) in enumerate(points):
        scale = float(scales[i])
        step_ms = max(float(total_step[i]), 1e-9)
        time_ms = step_ms * scale
        throughput = ref_units / (time_ms * 1e-3)
        comm = dataclasses.replace(
            comms[i],
            overlap=model.calibration.overlap_for(point.strategy),
            exposed_seconds=float(exposed_step[i]) * 1e-3)
        out.append(Prediction(
            point=point, feasibility=feas,
            compute_ms=float(comp_step[i]) * scale,
            comm_ms=float(exposed_step[i]) * scale,
            time_ms=time_ms,
            lo_ms=max(time_ms * (1.0 - band), 0.0),
            hi_ms=time_ms * (1.0 + band),
            step_ms=step_ms,
            throughput_sps=throughput,
            efficiency_sps_per_device=throughput / point.n_devices,
            device_seconds=time_ms * 1e-3 * point.n_devices,
            mem_headroom_bytes=feas.mem_headroom_bytes,
            dominant_term=_dominant_term(float(comp_step[i]), comm,
                                         float(exposed_step[i])),
            comm=comm))
    return out
