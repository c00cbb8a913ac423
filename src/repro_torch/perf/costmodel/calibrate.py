"""Fit link parameters from measured residuals; serialize the calibration
(``repro.perf.costmodel.calibrate`` without its CLI).

A measured sweep records, per trial, both the real sharded iteration time
(``t_measured_sharded``) and the single-device compute time of the
per-device sub-batch (``measured_ms``). Their difference is what the α-β
schedule layer claims to predict:

    residual_s(row) ≈ Σ_op hops_op·α_op + volume_op / bw_op

which is linear in each link's (α, 1/bw) once the schedule is reduced to
per-collective coefficients (``primitives.schedule_coefficients``). The
fit runs the port's differential evolution (``repro_torch.core.de``) over
log-spaced bounds, on the device the caller names, with MAE as the cost.

``load_calibration`` resolves the calibration every simulation consumer
shares, in the reference's order: explicit path → ``$REPRO_CALIBRATION``
→ the checked-in ``benchmarks/artifacts/comm_calibration.json`` →
the documented defaults, failing soft on a named artifact that is missing
or unparsable.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.perf.costmodel.primitives import (COLLECTIVES, DEFAULT_LINK,
                                                   LinkParams, Links,
                                                   schedule_coefficients)
from repro_torch.perf.costmodel.schedules import (ScheduleInputs,
                                                  build_schedule,
                                                  strategy_comm_seconds)

SCHEMA_VERSION = 2                 # v2 adds the per-strategy overlap map
_ACCEPTED_VERSIONS = (1, 2)        # v1 artifacts load with overlap = None

# log10 search bounds: α ∈ [10ns, 10ms] per hop, bw ∈ [100 KB/s, 10 TB/s].
LOG_ALPHA_BOUNDS = (-8.0, -2.0)
LOG_BW_BOUNDS = (5.0, 13.0)
OVERLAP_BOUNDS = (0.0, 1.0)        # ρ: fraction of compute that hides comm

ENV_VAR = "REPRO_CALIBRATION"      # path override; "" / "none" = defaults


def default_calibration_path() -> str:
    """The checked-in artifact fitted from the reference's measured sweep."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))
    return os.path.join(repo, "benchmarks", "artifacts",
                        "comm_calibration.json")


@dataclass(frozen=True)
class Calibration:
    """A named set of link parameters the schedule layer prices with.

    ``label`` flows into sweep rows (the ``calibration`` column) so every
    simulated number is traceable to the link that produced it.

    ``overlap`` (schema v2) maps strategy name → fitted overlap factor
    ρ ∈ [0, 1]: the fraction of a row's compute time that hides
    communication in the overlap train step (exposed comm =
    max(0, comm − ρ·compute), ``schedules.exposed_comm_seconds``).
    ``None``/absent strategies price fully serialized (ρ = 0), which is
    exactly the v1 behaviour — old artifacts stay loadable.
    """
    label: str = "default"
    default: LinkParams = DEFAULT_LINK
    per_collective: Optional[Mapping[str, LinkParams]] = None
    overlap: Optional[Mapping[str, float]] = None
    meta: Mapping[str, object] = field(default_factory=dict)

    def links(self) -> Links:
        if not self.per_collective:
            return self.default
        return {**dict(self.per_collective), "default": self.default}

    def overlap_for(self, strategy) -> float:
        """Fitted ρ of ``strategy`` (0.0 when unfitted: fully exposed)."""
        if not self.overlap:
            return 0.0
        name = getattr(strategy, "name", strategy)
        return float(self.overlap.get(str(name), 0.0))

    def to_dict(self) -> Dict:
        return {"version": SCHEMA_VERSION, "label": self.label,
                "default": self.default.to_dict(),
                "per_collective": (
                    None if not self.per_collective else
                    {k: v.to_dict()
                     for k, v in self.per_collective.items()}),
                "overlap": (None if not self.overlap
                            else {k: float(v)
                                  for k, v in self.overlap.items()}),
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Calibration":
        if int(d.get("version", 0)) not in _ACCEPTED_VERSIONS:
            raise ValueError(f"unsupported calibration schema version "
                             f"{d.get('version')!r} "
                             f"(accept {_ACCEPTED_VERSIONS})")
        pc = d.get("per_collective") or None
        ov = d.get("overlap") or None
        return cls(label=str(d.get("label", "fitted")),
                   default=LinkParams.from_dict(d["default"]),
                   per_collective=(None if pc is None else
                                   {k: LinkParams.from_dict(v)
                                    for k, v in pc.items()}),
                   overlap=(None if ov is None else
                            {k: float(v) for k, v in ov.items()}),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))


DEFAULT_CALIBRATION = Calibration()

REGEN_HINT = ("regenerate it with `PYTHONPATH=src python -m "
              "repro.perf.costmodel.calibrate --rows "
              "benchmarks/artifacts/lenet_sweep_measured.json` or the "
              "full `python -m benchmarks.measured_sweep`")


def _fail_soft(path: str, problem: str, strict: bool) -> Calibration:
    msg = (f"calibration artifact {path!r} {problem}; {REGEN_HINT}. "
           f"Falling back to the uncalibrated α-β defaults "
           f"(label 'default') — simulated times are NOT fitted to "
           f"this host until the artifact exists.")
    if strict:
        raise FileNotFoundError(msg)
    import warnings
    warnings.warn(msg, stacklevel=3)
    return DEFAULT_CALIBRATION


def load_calibration(path: Optional[str] = None, *,
                     strict: bool = False) -> Calibration:
    """Resolve the calibration every simulation consumer shares.

    Order: explicit ``path`` → $REPRO_CALIBRATION ("" or "none" forces
    the documented defaults) → the checked-in artifact → defaults.

    A named artifact (explicit ``path`` or env var) that is missing or
    unparsable fails *soft*: a warning with the regeneration command is
    emitted and the documented defaults are returned, whose ``label`` is
    ``"default"`` — consumers like the planner surface that as
    "uncalibrated α-β defaults in use" instead of a raw file error.
    ``strict=True`` restores the raising behaviour for callers that
    must not run uncalibrated.
    """
    if path is None:
        env = os.environ.get(ENV_VAR)
        if env is not None:
            if env.strip().lower() in ("", "none", "default"):
                return DEFAULT_CALIBRATION
            path = env
        else:
            path = default_calibration_path()
            if not os.path.exists(path):
                # the checked-in artifact is genuinely optional: absence
                # is the documented default, not worth a warning
                return DEFAULT_CALIBRATION
    if not os.path.exists(path):
        return _fail_soft(path, "does not exist", strict)
    try:
        return Calibration.load(path)
    except (ValueError, KeyError, json.JSONDecodeError, OSError) as e:
        return _fail_soft(path, f"failed to load ({e})", strict)


# ---------------------------------------------------------------------------
# Residual extraction
# ---------------------------------------------------------------------------

def row_inputs(row: Mapping) -> ScheduleInputs:
    """ScheduleInputs of one sweep-row dict (old rows lack act_bytes)."""
    f = row["features"]
    return ScheduleInputs(n_devices=int(f["n_devices"]),
                          param_bytes=int(row["param_bytes"]),
                          wire_bits=int(f.get("wire_bits", 32)),
                          act_bytes=int(row.get("act_bytes", 0)))


def calibration_rows(rows: Sequence[Mapping]) -> List[Mapping]:
    """Rows that constrain the link: a real sharded measurement exists
    and at least one collective actually ran (n_devices > 1)."""
    return [r for r in rows
            if "error" not in r
            and r.get("t_measured_sharded") is not None
            and int(r["features"]["n_devices"]) > 1]


def residual_matrices(rows: Sequence[Mapping]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, V, y): per-row hops/volume coefficients and residual seconds.

    ``H[r, k]`` / ``V[r, k]`` are the accumulated ring hops and payload
    volume of collective kind ``COLLECTIVES[k]`` in row r's schedule, so
    any link assignment prices the whole dataset as ``H @ α + V @ (1/bw)``.
    """
    H = np.zeros((len(rows), len(COLLECTIVES)))
    V = np.zeros((len(rows), len(COLLECTIVES)))
    y = np.zeros(len(rows))
    for i, r in enumerate(rows):
        sched = build_schedule(r["features"]["strategy"], row_inputs(r))
        for op, (h, v) in schedule_coefficients(sched).items():
            k = COLLECTIVES.index(op)
            H[i, k], V[i, k] = h, v
        y[i] = (float(r["t_measured_sharded"])
                - float(r["measured_ms"])) * 1e-3
    return H, V, y


def _fit_links(H: np.ndarray, V: np.ndarray, y: np.ndarray,
               kinds: Sequence[str], *, seeds: Sequence[int],
               maxiter: int, device) -> Tuple[Dict[str, LinkParams], float]:
    """DE over log10 link params of ``kinds``; returns (links, mae_s)."""
    import torch

    from repro_torch.core.de import de_multi_seed

    idx = [COLLECTIVES.index(k) for k in kinds]
    Ht = torch.tensor(H[:, idx], dtype=torch.float32, device=device)
    Vt = torch.tensor(V[:, idx], dtype=torch.float32, device=device)
    yt = torch.tensor(y, dtype=torch.float32, device=device)
    m = len(kinds)

    def cost(x):                       # x [..., 2m] -> [...]
        alphas = 10.0 ** x[..., :m]
        inv_bw = 10.0 ** (-x[..., m:])
        pred = alphas @ Ht.T + inv_bw @ Vt.T
        return (pred - yt).abs().mean(-1)

    lo = np.array([LOG_ALPHA_BOUNDS[0]] * m + [LOG_BW_BOUNDS[0]] * m)
    hi = np.array([LOG_ALPHA_BOUNDS[1]] * m + [LOG_BW_BOUNDS[1]] * m)
    results = de_multi_seed(cost, (lo, hi), seeds, maxiter=maxiter,
                            device=device)
    best = min(results, key=lambda r: float(r.fun))
    x = best.x.double().cpu().numpy()
    links = {k: LinkParams(alpha_s=float(10.0 ** x[j]),
                           bw_bytes_per_s=float(10.0 ** x[m + j]))
             for j, k in enumerate(kinds)}
    return links, float(best.fun)


def overlap_matrices(rows: Sequence[Mapping]
                     ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(compute_s, S, strategies) for the joint overlap fit.

    ``compute_s[r]`` is row r's measured single-device compute seconds
    (the quantity ρ scales); ``S[r, j]`` one-hot selects the row's
    strategy so the DE fits one ρ per strategy present in the data.
    """
    strategies = sorted({str(r["features"]["strategy"]) for r in rows})
    c = np.array([float(r["measured_ms"]) * 1e-3 for r in rows])
    S = np.zeros((len(rows), len(strategies)))
    for i, r in enumerate(rows):
        S[i, strategies.index(str(r["features"]["strategy"]))] = 1.0
    return c, S, strategies


def _fit_links_overlap(H: np.ndarray, V: np.ndarray, y: np.ndarray,
                       kinds: Sequence[str], compute: np.ndarray,
                       strat_onehot: np.ndarray, strategies: Sequence[str],
                       *, seeds: Sequence[int], maxiter: int, device
                       ) -> Tuple[Dict[str, LinkParams], Dict[str, float],
                                  float]:
    """Joint DE over link params of ``kinds`` plus one ρ per strategy.

    The residual model becomes the *exposed* communication
    ``relu(H@α + V@(1/bw) − (S@ρ)·compute)`` — what the overlap train
    step leaves on the wall clock — so the link and the overlap factors
    are fitted against each other instead of ρ absorbing link error.
    """
    import torch

    from repro_torch.core.de import de_multi_seed

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    idx = [COLLECTIVES.index(k) for k in kinds]
    Ht, Vt, yt = t(H[:, idx]), t(V[:, idx]), t(y)
    ct, St = t(compute), t(strat_onehot)
    m, p = len(kinds), len(strategies)

    def cost(x):                       # x [..., 2m + p] -> [...]
        alphas = 10.0 ** x[..., :m]
        inv_bw = 10.0 ** (-x[..., m:2 * m])
        rho = x[..., 2 * m:]
        comm = alphas @ Ht.T + inv_bw @ Vt.T
        pred = torch.clamp_min(comm - (rho @ St.T) * ct, 0.0)
        return (pred - yt).abs().mean(-1)

    lo = np.array([LOG_ALPHA_BOUNDS[0]] * m + [LOG_BW_BOUNDS[0]] * m
                  + [OVERLAP_BOUNDS[0]] * p)
    hi = np.array([LOG_ALPHA_BOUNDS[1]] * m + [LOG_BW_BOUNDS[1]] * m
                  + [OVERLAP_BOUNDS[1]] * p)
    results = de_multi_seed(cost, (lo, hi), seeds, maxiter=maxiter,
                            device=device)
    best = min(results, key=lambda r: float(r.fun))
    x = best.x.double().cpu().numpy()
    links = {k: LinkParams(alpha_s=float(10.0 ** x[j]),
                           bw_bytes_per_s=float(10.0 ** x[m + j]))
             for j, k in enumerate(kinds)}
    rho = {s: float(x[2 * m + j]) for j, s in enumerate(strategies)}
    return links, rho, float(best.fun)


def _mae_from_matrices(H: np.ndarray, V: np.ndarray, y: np.ndarray,
                       links: Links) -> float:
    """MAE of ``links`` priced directly on the coefficient matrices —
    ``Σ_op H·α_op + V/bw_op`` per row, no schedule rebuilding."""
    if not len(y):
        return 0.0
    from repro_torch.perf.costmodel.primitives import link_for
    alphas = np.array([link_for(op, links).alpha_s for op in COLLECTIVES])
    inv_bw = np.array([1.0 / link_for(op, links).bw_bytes_per_s
                       for op in COLLECTIVES])
    pred = H @ alphas + V @ inv_bw
    return float(np.mean(np.abs(pred - y)))


def dataset_mae_s(rows: Sequence[Mapping], links: Links) -> float:
    """Mean |predicted − residual| seconds of ``links`` over ``rows``."""
    return _mae_from_matrices(*residual_matrices(rows), links)


def fit_calibration(rows: Sequence[Mapping], *,
                    per_collective: bool = False,
                    overlap: bool = False,
                    seeds: Sequence[int] = (0, 1, 2),
                    maxiter: int = 200,
                    label: Optional[str] = None,
                    source: str = "", device="cuda") -> Calibration:
    """Fit LinkParams against the measured−compute residuals of ``rows``.

    Always fits one shared link; with ``per_collective=True`` each
    collective kind present in the data additionally gets its own link
    (absent kinds fall back to the shared fit). With ``overlap=True`` a
    per-strategy overlap factor ρ is fitted *jointly* with the link(s):
    the residual model becomes the exposed communication
    ``max(0, comm − ρ·compute)`` of the overlap train step. Raises if no
    row constrains the link (no sharded measurements above one device).
    The DE runs on ``device``.
    """
    from repro_torch import resolve_device
    dev = resolve_device(device)
    ok = calibration_rows(rows)
    if not ok:
        raise ValueError("no calibration rows: need t_measured_sharded "
                         "with n_devices > 1 (run the measured sweep)")
    H, V, y = residual_matrices(ok)
    link, shared_mae = _fit_shared(H, V, y, seeds=seeds, maxiter=maxiter,
                                   device=dev)
    pc: Optional[Dict[str, LinkParams]] = None
    mae = shared_mae
    present = [k for j, k in enumerate(COLLECTIVES)
               if (H[:, j] > 0).any() or (V[:, j] > 0).any()]
    if per_collective:
        pc, mae = _fit_links(H, V, y, present, seeds=seeds,
                             maxiter=maxiter, device=dev)
    rho: Optional[Dict[str, float]] = None
    mae_serialized = mae
    if overlap:
        c, S, strategies = overlap_matrices(ok)
        if per_collective:
            pc, rho, mae = _fit_links_overlap(H, V, y, present, c, S,
                                              strategies, seeds=seeds,
                                              maxiter=maxiter, device=dev)
        else:
            Hs = H.sum(axis=1, keepdims=True)
            Vs = V.sum(axis=1, keepdims=True)
            lks, rho, mae = _fit_links_overlap(Hs, Vs, y, [COLLECTIVES[0]],
                                               c, S, strategies,
                                               seeds=seeds, maxiter=maxiter,
                                               device=dev)
            link = lks[COLLECTIVES[0]]
    mae_default = _mae_from_matrices(H, V, y, DEFAULT_LINK)
    mode = "per_collective" if per_collective else "global"
    if overlap:
        mode += "+overlap"
    meta = {"n_rows": len(ok), "source": source, "mode": mode,
            "mae_ms_default": mae_default * 1e3,
            "mae_ms_shared": shared_mae * 1e3,
            "mae_ms_serialized": mae_serialized * 1e3,
            "mae_ms_fitted": mae * 1e3,
            "seeds": list(seeds), "maxiter": int(maxiter)}
    return Calibration(
        label=label or ("fitted:" + mode.replace("_", "-")),
        default=link, per_collective=pc, overlap=rho, meta=meta)


def _fit_shared(H, V, y, *, seeds, maxiter, device
                ) -> Tuple[LinkParams, float]:
    """One link for every collective kind: collapse the coefficient
    matrix to a single column and reuse the generic fitter."""
    Hs = H.sum(axis=1, keepdims=True)
    Vs = V.sum(axis=1, keepdims=True)
    links, mae = _fit_links(Hs, Vs, y, [COLLECTIVES[0]],
                            seeds=seeds, maxiter=maxiter, device=device)
    return links[COLLECTIVES[0]], mae


# ---------------------------------------------------------------------------
# Cross-family calibration (the arch sweep's transfer question)
# ---------------------------------------------------------------------------

def fit_family_calibrations(rows_by_family: Mapping[str, Sequence[Mapping]],
                            *, per_collective: bool = False,
                            overlap: bool = False,
                            seeds: Sequence[int] = (0, 1, 2),
                            maxiter: int = 200,
                            source: str = "",
                            device="cuda") -> Dict[str, Calibration]:
    """One fitted Calibration per architecture family (labels
    ``fitted:<family>``). Families whose rows cannot constrain a link
    (no multi-device sharded measurements) are silently absent — the
    transfer matrix then simply has no row for them. ``overlap=True``
    jointly fits each family's per-strategy ρ (see ``fit_calibration``)."""
    out: Dict[str, Calibration] = {}
    for family, rows in rows_by_family.items():
        if not calibration_rows(rows):
            continue
        out[family] = fit_calibration(rows, per_collective=per_collective,
                                      overlap=overlap,
                                      seeds=seeds, maxiter=maxiter,
                                      label=f"fitted:{family}",
                                      source=source or family, device=device)
    return out


def link_transfer_matrix(rows_by_family: Mapping[str, Sequence[Mapping]],
                         calibrations: Mapping[str, Calibration]
                         ) -> Dict[str, Dict[str, float]]:
    """``matrix[fit_family][eval_family]`` = residual MAE (ms) of the
    link fitted on one family priced on another family's rows — the
    paper-level question of whether calibrated link parameters are a
    property of the *interconnect* (they should transfer across
    families without refitting) or leak workload shape. The diagonal is
    each family's own fit; ``matrix["default"]`` prices every family
    with the uncalibrated α-β defaults as the no-fit baseline."""
    evals = {f: calibration_rows(rows)
             for f, rows in rows_by_family.items()}
    evals = {f: r for f, r in evals.items() if r}
    matrix: Dict[str, Dict[str, float]] = {}
    for fit_f, cal in calibrations.items():
        matrix[fit_f] = {ev_f: dataset_mae_s(rows, cal.links()) * 1e3
                         for ev_f, rows in evals.items()}
    matrix["default"] = {ev_f: dataset_mae_s(rows, DEFAULT_LINK) * 1e3
                         for ev_f, rows in evals.items()}
    return matrix


# ---------------------------------------------------------------------------
# Re-simulation (calibrated-vs-default comparison)
# ---------------------------------------------------------------------------

def resimulate_rows(rows: Sequence[Mapping],
                    calibration: Calibration) -> List[Dict]:
    """Sweep rows with the simulated columns re-priced under a calibration.

    ``comm_ms`` / ``t_simulated`` / ``time_ms`` are recomputed from the
    row's own schedule inputs; measured columns and features are
    untouched, so the result feeds the same fit/report pipeline as the
    original rows (``calibration`` column records the link's label).
    When the calibration carries fitted overlap factors, ``t_simulated``
    adds only the *exposed* communication max(0, comm − ρ·compute) —
    the full schedule price stays in ``comm_ms`` and the exposed part
    lands in ``exposed_comm_ms``.
    """
    out: List[Dict] = []
    links = calibration.links()
    for r in rows:
        if "error" in r:
            out.append(dict(r))
            continue
        strategy = r["features"]["strategy"]
        comm_ms = strategy_comm_seconds(strategy, row_inputs(r),
                                        links) * 1e3
        rho = calibration.overlap_for(strategy)
        exposed_ms = max(0.0, comm_ms - rho * float(r["measured_ms"]))
        t_sim = float(r["measured_ms"]) + exposed_ms
        out.append({**r, "comm_ms": comm_ms, "exposed_comm_ms": exposed_ms,
                    "overlap": rho, "t_simulated": t_sim,
                    "time_ms": t_sim, "calibration": calibration.label})
    return out
