"""Align measurements against the cost model's own per-term predictions
(``repro.obs.attribution``; the measured side runs over a ``dist.pool``).

The calibrated schedule layer predicts a step as a sum of *terms*:

    t_step ≈ compute + Σ_term comm_term          (serialized, ρ = 0)
    t_step ≈ compute + max(0, Σ comm − ρ·compute)  (overlap-fitted)

where each communication term is one ``op/axis/tensor`` group of the
strategy's schedule (``perf.costmodel.schedules.build_schedule``). This
module makes each term falsifiable on its own:

* ``predicted_terms`` / ``predicted_step_ms``: the model's per-term
  milliseconds under a calibration (the uncalibrated defaults price too,
  labelled ``"default"``);
* ``measure_collective_terms``: runs each term's collective alone over a
  ``Pool``'s mesh axis with the term's byte count, and times it. On ranks
  that share one card over gloo every one of them is a host round trip
  (the all-gather, reduce-scatter and all-to-all on host copies, as the
  port's own step gathers; the all-reduce on the device tensor, which gloo
  stages through the host): what the port's step pays, not a link;
* ``region_terms``: a sharded step's measured compute and comm from
  ``train.step.RegionTimer``'s four ``obs:`` regions;
* ``attribution_table`` / ``render_markdown``: measured against predicted
  per term;
* ``span_coverage``: whether a step span's children partition its time;
* ``detect_drift``: terms whose live error exceeds the calibration-time
  band, with the refit recommendation (``calibrate.REGEN_HINT``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.perf.costmodel.calibrate import (REGEN_HINT, Calibration,
                                                  load_calibration)
from repro_torch.perf.costmodel.schedules import ScheduleInputs, build_schedule

TERM_COMPUTE = "compute"          # the non-communication term's key


def term_key(call) -> str:
    """The stable name of a schedule term: ``op/axis/tensor``."""
    return f"{call.op}/{call.axis}/{call.tensor}"


def predicted_terms(strategy, inp: ScheduleInputs, *,
                    calibration: Optional[Calibration] = None,
                    axes: Optional[Dict[str, int]] = None
                    ) -> Dict[str, Dict[str, Any]]:
    """Per-term predicted milliseconds of one iteration's schedule;
    identical calls collapse into one term with a ``count``."""
    if calibration is None:
        calibration = load_calibration()
    links = calibration.links()
    out: Dict[str, Dict[str, Any]] = {}
    for call in build_schedule(strategy, inp, axes=axes):
        t = out.setdefault(term_key(call), {
            "op": call.op, "axis": call.axis, "tensor": call.tensor,
            "ring": call.n_devices, "bytes": 0.0, "count": 0, "ms": 0.0})
        t["bytes"] += float(call.nbytes)
        t["count"] += 1
        t["ms"] += call.seconds(links) * 1e3
    return out


def predicted_step_ms(strategy, inp: ScheduleInputs, *, compute_ms: float,
                      calibration: Optional[Calibration] = None,
                      axes: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """``total_ms = compute + max(0, comm − ρ·compute)`` with the fitted
    per-strategy overlap factor (ρ = 0 uncalibrated)."""
    if calibration is None:
        calibration = load_calibration()
    terms = predicted_terms(strategy, inp, calibration=calibration, axes=axes)
    comm_ms = sum(t["ms"] for t in terms.values())
    rho = calibration.overlap_for(strategy)
    exposed_ms = max(0.0, comm_ms - rho * float(compute_ms))
    return {"compute_ms": float(compute_ms), "comm_ms": comm_ms,
            "exposed_comm_ms": exposed_ms, "overlap": rho,
            "total_ms": float(compute_ms) + exposed_ms}


# ---------------------------------------------------------------------------
# Measured side: each term's collective alone on the pool's mesh
# ---------------------------------------------------------------------------

def _term_groups(strategy, inp: ScheduleInputs, axes) -> Dict[str, Dict[str, Any]]:
    groups: Dict[str, Dict[str, Any]] = {}
    for call in build_schedule(strategy, inp, axes=axes):
        g = groups.setdefault(term_key(call), {
            "op": call.op, "axis": call.axis, "tensor": call.tensor,
            "ring": call.n_devices, "nbytes": float(call.nbytes), "count": 0})
        g["count"] += 1
    return groups


def _collective(op: str, x, group, device):
    """One collective of ``x`` over ``group``, waited for, its result on
    ``device``. ``nbytes`` follows the α-β convention (``_measure_rank``)."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.dist.sharding import _waited, all_reduce
    if op == "all_reduce":
        return all_reduce(x, "sum", group)
    host = x.cpu()
    if op == "reduce_scatter":
        y = funcol.reduce_scatter_tensor(host, "sum", 0, group)
    elif op == "all_gather":
        y = funcol.all_gather_tensor(host, 0, group)
    elif op == "all_to_all":
        y = funcol.all_to_all_single(host, None, None, group)
    else:
        raise ValueError(f"unknown collective {op!r}")
    return _waited(y, op.replace("_", "-"), host, group).to(device)


def _measure_rank(ctx, groups, iters: int, warmup: int):
    """Pool job: this rank's best seconds of each term's collective. The
    operand follows the α-β convention: ``nbytes`` is the full logical
    tensor, held per rank by all_reduce / reduce_scatter / all_to_all and
    gathered up to by all_gather (whose input is the 1/ring block)."""
    import torch

    from repro_torch.dist.sharding import all_reduce
    device, mesh = ctx.device, ctx.mesh
    out = {}
    barrier = mesh.group(mesh.axis_names)
    for key, g in groups.items():
        ring = g["ring"]
        elems = max(int(g["nbytes"]) // 4, ring)           # fp32
        elems -= elems % ring                              # divisible shards
        n = elems // ring if g["op"] == "all_gather" else elems
        x = torch.arange(n, dtype=torch.float32, device=device)
        group = mesh.group(g["axis"])
        best = math.inf
        for i in range(max(warmup, 1) + max(iters, 1)):
            all_reduce(torch.zeros(1, device=device), "sum", barrier)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            y = _collective(g["op"], x, group, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if i >= max(warmup, 1):
                best = min(best, time.perf_counter() - t0)
            del y
        out[key] = best
    return out


def measure_collective_terms(pool, strategy, inp: ScheduleInputs, *,
                             axes: Optional[Dict[str, int]] = None,
                             iters: int = 10, warmup: int = 3
                             ) -> Dict[str, Dict[str, Any]]:
    """Measured milliseconds of each schedule term on ``pool``'s ranks laid
    out as ``axes`` (default ``mesh_axes_for(strategy, n)``): each
    ``op/axis/tensor`` group is run as its collective over its axis with
    its byte count, warmed up and timed (the best of ``iters`` on each
    rank, the slowest rank's best: a collective ends when its last rank
    does); the group's ``ms`` is one call's time × its call count. The
    keys are ``predicted_terms``'."""
    from repro_torch.perf.costmodel.schedules import mesh_axes_for
    if axes is None:
        axes = mesh_axes_for(strategy, inp.n_devices)
    groups = _term_groups(strategy, inp, axes)
    ranks = pool.run(_measure_rank, groups, iters, warmup, mesh=dict(axes))
    out: Dict[str, Dict[str, Any]] = {}
    for key, g in groups.items():
        best = max(r[key] for r in ranks)
        out[key] = {**{k: g[k] for k in ("op", "axis", "tensor", "ring", "count")},
                    "bytes": g["nbytes"] * g["count"],
                    "ms_per_call": best * 1e3, "ms": best * 1e3 * g["count"]}
    return out


# The regions ``train.step.RegionTimer`` times on a sharded step's rank, by
# the term they measure (the reference's ``obs:`` named scopes).
REGION_TERMS = {"gather_params": "comm", "grad_reduce": "comm",
                "grad_compute": "compute", "update": "compute"}


def region_terms(regions_ms: Mapping[str, float]) -> Dict[str, float]:
    """A sharded step's measured compute and comm milliseconds from its
    regions' (one step's, or a median step's) times."""
    out = {"compute_ms": 0.0, "comm_ms": 0.0}
    for name, ms in regions_ms.items():
        kind = REGION_TERMS.get(name)
        if kind is not None:
            out[f"{kind}_ms"] += float(ms)
    return out


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

@dataclass
class TermRow:
    """One line of the measured-vs-predicted attribution table."""
    term: str
    predicted_ms: float
    measured_ms: Optional[float] = None
    count: int = 1
    nbytes: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def residual_ms(self) -> Optional[float]:
        if self.measured_ms is None:
            return None
        return self.measured_ms - self.predicted_ms

    @property
    def ratio(self) -> Optional[float]:
        if self.measured_ms is None or self.predicted_ms <= 0:
            return None
        return self.measured_ms / self.predicted_ms

    def to_dict(self) -> Dict[str, Any]:
        return {"term": self.term, "predicted_ms": self.predicted_ms,
                "measured_ms": self.measured_ms,
                "residual_ms": self.residual_ms, "ratio": self.ratio,
                "count": self.count, "bytes": self.nbytes, **self.attrs}


def attribution_table(predicted: Mapping[str, Mapping[str, Any]],
                      measured: Optional[Mapping[str, Mapping[str, Any]]] = None,
                      *, compute_ms: Optional[float] = None,
                      measured_compute_ms: Optional[float] = None) -> List[TermRow]:
    """Join predicted and measured per-term milliseconds into rows. The
    compute term rides first when given (its predicted column defaults to
    the measured value); a term only one side knows stays with the other
    column empty."""
    rows: List[TermRow] = []
    if measured_compute_ms is not None or compute_ms is not None:
        pred_c = compute_ms if compute_ms is not None else measured_compute_ms
        rows.append(TermRow(TERM_COMPUTE, float(pred_c), measured_compute_ms,
                            attrs={"kind": "compute"}))
    measured = measured or {}
    for key in sorted(set(predicted) | set(measured)):
        p = predicted.get(key)
        m = measured.get(key)
        src = p or m or {}
        rows.append(TermRow(
            term=key,
            predicted_ms=float(p["ms"]) if p else 0.0,
            measured_ms=(None if m is None else float(m["ms"])),
            count=int(src.get("count", 1)),
            nbytes=float(src.get("bytes", 0.0)),
            attrs={"kind": "comm", "op": src.get("op", ""),
                   "axis": src.get("axis", ""), "ring": src.get("ring", 0)}))
    return rows


def _fmt_ms(v: Optional[float]) -> str:
    return "—" if v is None else f"{v:.3f}"


def render_markdown(rows: Sequence[TermRow], *, title: str = "") -> str:
    """The attribution table as GitHub markdown."""
    lines: List[str] = []
    if title:
        lines += [f"#### {title}", ""]
    lines += ["| term | count | bytes | predicted ms | measured ms "
              "| residual ms | meas/pred |",
              "|---|---:|---:|---:|---:|---:|---:|"]
    for r in rows:
        ratio = "—" if r.ratio is None else f"{r.ratio:.2f}×"
        nb = "—" if r.nbytes <= 0 else f"{int(r.nbytes):,}"
        lines.append(f"| `{r.term}` | {r.count} | {nb} "
                     f"| {_fmt_ms(r.predicted_ms)} "
                     f"| {_fmt_ms(r.measured_ms)} "
                     f"| {_fmt_ms(r.residual_ms)} | {ratio} |")
    tot_p = sum(r.predicted_ms for r in rows)
    meas = [r.measured_ms for r in rows if r.measured_ms is not None]
    tot_m = sum(meas) if meas else None
    lines.append(f"| **total** |  |  | **{_fmt_ms(tot_p)}** "
                 f"| **{_fmt_ms(tot_m)}** "
                 f"| **{_fmt_ms(None if tot_m is None else tot_m - tot_p)}**"
                 f" |  |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Span coverage (the attribution-sum invariant)
# ---------------------------------------------------------------------------

def span_coverage(spans: Sequence, parent_name: str) -> Dict[str, Any]:
    """How much of each ``parent_name`` span its children account for:
    per-child-name total milliseconds and ``coverage`` = Σ children / Σ
    parents over all closed instances."""
    parents = [s for s in spans if s.name == parent_name and s.t_end is not None]
    ids = {s.span_id for s in parents}
    child_ms: Dict[str, float] = {}
    child_total = 0.0
    for s in spans:
        if s.parent_id in ids and s.t_end is not None:
            ms = s.duration_s * 1e3
            child_ms[s.name] = child_ms.get(s.name, 0.0) + ms
            child_total += ms
    parent_ms = sum(s.duration_s for s in parents) * 1e3
    return {"parent": parent_name, "n": len(parents),
            "parent_ms": parent_ms, "children_ms": child_ms,
            "children_total_ms": child_total,
            "coverage": (child_total / parent_ms if parent_ms > 0 else None)}


# ---------------------------------------------------------------------------
# Drift detection
# ---------------------------------------------------------------------------

@dataclass
class DriftReport:
    """Which terms drifted outside the calibration-time error band."""
    band_ms: float
    rel_tol: float
    flagged: List[Dict[str, Any]] = field(default_factory=list)
    calibration_label: str = "default"

    @property
    def refit_recommended(self) -> bool:
        return bool(self.flagged)

    @property
    def message(self) -> str:
        if not self.flagged:
            return (f"all terms within the calibration band "
                    f"(±{self.band_ms:.3f} ms or ±{self.rel_tol:.0%}) of "
                    f"{self.calibration_label!r}")
        names = ", ".join(f["term"] for f in self.flagged)
        return (f"{len(self.flagged)} term(s) drifted beyond the "
                f"calibration band (±{self.band_ms:.3f} ms and "
                f"±{self.rel_tol:.0%}) of {self.calibration_label!r}: "
                f"{names} — refit recommended; {REGEN_HINT}")

    def to_dict(self) -> Dict[str, Any]:
        return {"band_ms": self.band_ms, "rel_tol": self.rel_tol,
                "calibration": self.calibration_label,
                "flagged": list(self.flagged),
                "refit_recommended": self.refit_recommended,
                "message": self.message}


def detect_drift(rows: Sequence[TermRow], calibration: Optional[Calibration] = None,
                 *, band_factor: float = 2.0, floor_ms: float = 0.25,
                 rel_tol: float = 0.5) -> DriftReport:
    """Flag terms whose live residual exceeds ``band_factor ×`` the fit's
    own residual MAE (``meta["mae_ms_fitted"]``, floored at ``floor_ms``)
    *and* ``rel_tol`` of the prediction. An uncalibrated run uses the
    floor, so it still gets a verdict."""
    if calibration is None:
        calibration = load_calibration()
    mae = calibration.meta.get("mae_ms_fitted") if calibration.meta else None
    band_ms = max(band_factor * float(mae), floor_ms) if mae is not None else floor_ms
    flagged: List[Dict[str, Any]] = []
    for r in rows:
        if r.measured_ms is None:
            continue
        resid = abs(r.residual_ms)
        if resid > band_ms and resid > rel_tol * max(r.predicted_ms, 1e-9):
            flagged.append({"term": r.term, "predicted_ms": r.predicted_ms,
                            "measured_ms": r.measured_ms,
                            "residual_ms": r.residual_ms, "band_ms": band_ms})
    return DriftReport(band_ms=band_ms, rel_tol=rel_tol, flagged=flagged,
                       calibration_label=calibration.label)
