"""Interpretability reports (``repro.core.interpret``, copied, numpy only):
the paper's Tables 2/3/6 as text, plus the measured-vs-simulated residual
report that quantifies how far the α-β communication simulation sits from
real sharded measurements recorded beside it. The same ``x`` prints the
same strings as the reference."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.generic_model import PerfModel


def table_rows(model: PerfModel) -> List[Dict]:
    """Rows with (kind, feature, a mean/std, p mean/std) — Tables 2/3."""
    spec = model.spec
    xs = model.x_seeds if model.x_seeds is not None else model.x[None]
    mean, std = xs.mean(0), xs.std(0)
    n = spec.n_num
    rows = []
    for i, f in enumerate(spec.numeric):
        rows.append({"kind": "intrinsic", "feature": f,
                     "a": (mean[i], std[i]),
                     "p": (mean[n + i], std[n + i])})
    off = 2 * n
    for cname, vals in spec.categorical:
        for v in vals:
            rows.append({"kind": "categorical", "feature": f"{cname}={v}",
                         "a": (mean[off], std[off]), "p": None})
            off += 1
    for j, f in enumerate(spec.extrinsic):
        rows.append({"kind": "extrinsic", "feature": f,
                     "q": (mean[off + j], std[off + j])})
    rows.append({"kind": "constant", "feature": "C",
                 "a": (mean[-1], std[-1])})
    return rows


def format_table(model: PerfModel, title: str = "") -> str:
    lines = [f"== {title} ==" if title else "== fitted constants =="]
    for r in table_rows(model):
        if r["kind"] == "extrinsic":
            m, s = r["q"]
            lines.append(f"  q  {r['feature']:<24s} {m:+8.3f} ± {s:.3f}")
        elif r["kind"] == "constant":
            m, s = r["a"]
            lines.append(f"  C  {'':<24s} {m:8.3f} ± {s:.3f}")
        else:
            m, s = r["a"]
            p = r.get("p")
            ptxt = f"  p={p[0]:+6.2f}±{p[1]:.2f}" if p else " " * 16
            lines.append(f"  a  {r['feature']:<24s} {m:8.2f} ± {s:<8.2f}"
                         f"{ptxt}")
    return "\n".join(lines)


def scaling_report(model: PerfModel) -> str:
    """Paper Table 6: extrinsic scaling powers; q=-1 is ideal scaling."""
    lines = ["== scaling analysis (q = -1 ideal) =="]
    for f, (m, s) in model.scaling_powers().items():
        verdict = ("ideal" if abs(m + 1) < 0.1 else
                   "super-linear" if m < -1.1 else "sub-optimal")
        lines.append(f"  {f:<20s} q = {m:+.3f} ± {s:.3f}   [{verdict}]")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Measured vs simulated (sweep rows with t_measured_sharded / t_simulated)
# ---------------------------------------------------------------------------

def _residual_stats(meas: np.ndarray, sim: np.ndarray) -> Dict[str, float]:
    rel = (sim - meas) / np.maximum(np.abs(meas), 1e-9)
    return {"n": int(len(meas)),
            "mape": float(np.mean(np.abs(rel))),
            "bias": float(np.mean(rel)),            # + = simulation slower
            "median_meas_ms": float(np.median(meas)),
            "median_sim_ms": float(np.median(sim))}


def measured_vs_simulated(rows: Sequence[Dict],
                          group_by: Sequence[str] = ("strategy",
                                                     "n_devices")
                          ) -> Dict[str, Dict[str, float]]:
    """Residuals of the α-β simulation against the real shard_map step.

    Consumes sweep row dicts carrying both ``t_simulated`` and
    ``t_measured_sharded`` (rows without the measured column — e.g. from
    a pool smaller than the trial — are skipped). Returns per-group
    stats keyed by the joined ``group_by`` feature values, plus an
    "overall" entry. ``bias`` is the mean signed relative error: positive
    means the simulation predicts *slower* than reality.
    """
    ok = [r for r in rows if "error" not in r
          and r.get("t_measured_sharded") is not None]
    if not ok:
        return {}
    meas = np.array([r["t_measured_sharded"] for r in ok])
    sim = np.array([r["t_simulated"] for r in ok])
    out = {"overall": _residual_stats(meas, sim)}
    keys = sorted({tuple(r["features"][g] for g in group_by) for r in ok})
    for key in keys:
        idx = [i for i, r in enumerate(ok)
               if tuple(r["features"][g] for g in group_by) == key]
        name = ",".join(f"{g}={v}" for g, v in zip(group_by, key))
        out[name] = _residual_stats(meas[idx], sim[idx])
    return out


def residual_report(rows: Sequence[Dict],
                    group_by: Sequence[str] = ("strategy", "n_devices")
                    ) -> str:
    """Human-readable measured-vs-simulated table (sweep rows)."""
    stats = measured_vs_simulated(rows, group_by)
    if not stats:
        return "== measured vs simulated ==\n  (no rows with both columns)"
    lines = ["== measured (shard_map) vs simulated (α-β) iteration time =="]
    for name, s in stats.items():
        lines.append(
            f"  {name:<28s} n={s['n']:<5d} MAPE {s['mape']:6.1%} "
            f"bias {s['bias']:+6.1%}  median meas {s['median_meas_ms']:8.2f}ms"
            f" / sim {s['median_sim_ms']:8.2f}ms")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Calibrated vs default simulation (repro_torch.perf.costmodel)
# ---------------------------------------------------------------------------

def calibration_comparison(rows: Sequence[Dict], calibration,
                           group_by: Sequence[str] = ("strategy",
                                                      "n_devices"),
                           *, rows_default: Optional[Sequence[Dict]] = None,
                           rows_calibrated: Optional[Sequence[Dict]] = None
                           ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Residual stats of the simulation before/after a calibration.

    "before" prices every row's communication schedule with the default
    link constants; "after" re-prices it with the fitted ``calibration``
    (``repro_torch.perf.costmodel.Calibration``). Rows are re-simulated from
    their own schedule inputs either way, so the comparison is apples-
    to-apples even on rows that were originally written under a
    different link. Callers that already re-simulated (e.g. for fitting)
    pass the lists via ``rows_default`` / ``rows_calibrated`` to skip
    the duplicate schedule pricing. Returns ``{group: {"default": stats,
    "calibrated": stats}}`` with the same group keys as
    ``measured_vs_simulated``.
    """
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION, resimulate_rows
    if rows_default is None:
        rows_default = resimulate_rows(rows, DEFAULT_CALIBRATION)
    if rows_calibrated is None:
        rows_calibrated = resimulate_rows(rows, calibration)
    before = measured_vs_simulated(rows_default, group_by)
    after = measured_vs_simulated(rows_calibrated, group_by)
    return {g: {"default": before[g], "calibrated": after[g]}
            for g in before if g in after}


def calibration_report(rows: Sequence[Dict], calibration,
                       group_by: Sequence[str] = ("strategy", "n_devices"),
                       *, rows_default: Optional[Sequence[Dict]] = None,
                       rows_calibrated: Optional[Sequence[Dict]] = None
                       ) -> str:
    """Before/after table: default constants vs calibrated link."""
    cmp = calibration_comparison(rows, calibration, group_by,
                                 rows_default=rows_default,
                                 rows_calibrated=rows_calibrated)
    if not cmp:
        return ("== calibrated vs default simulation ==\n"
                "  (no rows with both columns)")
    label = getattr(calibration, "label", "calibrated")
    lines = [f"== simulation residuals: default link vs {label} =="]
    for name, pair in cmp.items():
        d, c = pair["default"], pair["calibrated"]
        lines.append(
            f"  {name:<28s} n={d['n']:<5d} "
            f"MAPE {d['mape']:6.1%} -> {c['mape']:6.1%}   "
            f"bias {d['bias']:+6.1%} -> {c['bias']:+6.1%}")
    return "\n".join(lines)
