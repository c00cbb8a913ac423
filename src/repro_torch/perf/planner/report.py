"""Interpretable plan rendering + predicted-vs-measured ranking metrics
(``repro.perf.planner.report``).

The planner is scored on *decisions*, not residuals, so the metrics
here are ranking statistics over a validation slate:

  * ``kendall_tau`` — rank agreement between predicted and measured
    orderings (τ-a; 1 = identical order, −1 = reversed);
  * ``top1_regret`` — how much slower the planner's #1 pick measured
    than the measured-best pick, relative ((meas(top1) − min) / min);
  * ``top1_measured_rank`` — where the pick landed in measured order
    (the acceptance gate: ≤ 3 on a pool of 8).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.perf.planner.predict import Prediction


# ---------------------------------------------------------------------------
# Ranking metrics
# ---------------------------------------------------------------------------

def kendall_tau(pred: Sequence[float], meas: Sequence[float]) -> float:
    """τ-a over value pairs (ties count zero); O(n²), n is the slate."""
    if len(pred) != len(meas):
        raise ValueError(f"length mismatch {len(pred)} vs {len(meas)}")
    n = len(pred)
    if n < 2:
        return 0.0
    s = 0
    for i in range(n):
        for j in range(i + 1, n):
            a = np.sign(pred[i] - pred[j])
            b = np.sign(meas[i] - meas[j])
            s += int(a * b)
    return s / (n * (n - 1) / 2)


def ranking_metrics(pred_ms: Sequence[float],
                    meas_ms: Sequence[float]) -> Dict[str, float]:
    """Slate-level decision metrics; index 0 is the planner's top pick
    (the slate arrives sorted by predicted objective)."""
    pred = np.asarray(pred_ms, float)
    meas = np.asarray(meas_ms, float)
    best = float(meas.min())
    order = np.argsort(meas, kind="stable")
    rank_of = {int(i): r + 1 for r, i in enumerate(order)}
    top1_meas = float(meas[0])
    rel = (pred - meas) / np.maximum(np.abs(meas), 1e-12)
    return {"n": int(len(meas)),
            "kendall_tau": kendall_tau(pred.tolist(), meas.tolist()),
            "top1_regret": (top1_meas - best) / max(best, 1e-12),
            "top1_measured_rank": rank_of[0],
            "top1_in_measured_top3": bool(rank_of[0] <= 3),
            "mape": float(np.mean(np.abs(rel))),
            "bias": float(np.mean(rel))}


# ---------------------------------------------------------------------------
# Human-readable plan
# ---------------------------------------------------------------------------

def _mb(b: int) -> str:
    return f"{b / 2**20:.1f}MB"


def why(pred: Prediction, best: Prediction, objective: str) -> str:
    """One line of 'why this config is recommended'."""
    pt = pred.point
    bits = []
    if pred is best:
        bits.append(f"best {objective} in the feasible set")
    else:
        ratio = pred.time_ms / max(best.time_ms, 1e-12)
        bits.append(f"{ratio:.2f}× the best pick's time")
    share = pred.comm_ms / max(pred.time_ms, 1e-12)
    if pred.dominant_term == "compute":
        bits.append(f"compute-bound ({1 - share:.0%} compute)")
    else:
        bits.append(f"{pred.dominant_term} dominates ({share:.0%} comm)")
    if pt.n_devices == 1:
        bits.append("no collectives at 1 device")
    elif pt.compression != "none":
        bits.append(f"{pt.compression} wire format cuts grad volume to "
                    f"{pt.cfg.wire_bits}/32")
    return "; ".join(bits)


def plan_lines(picks: Sequence[Prediction], objective: str) -> List[str]:
    """Aligned text table of the recommended configs."""
    lines = [f"{'#':>2} {'strategy':<8} {'dev':>3} {'batch':>5} "
             f"{'wire':>4} {'t_pred':>9} {'band':>17} {'comm%':>6} "
             f"{'thru/s':>8} {'headroom':>9}  why"]
    best = picks[0] if picks else None
    for i, p in enumerate(picks):
        pt = p.point
        share = p.comm_ms / max(p.time_ms, 1e-12)
        lines.append(
            f"{i + 1:>2} {pt.strategy:<8} {pt.n_devices:>3} "
            f"{pt.batch_size:>5} {pt.cfg.wire_bits:>4} "
            f"{p.time_ms:>7.1f}ms "
            f"[{p.lo_ms:>6.1f},{p.hi_ms:>7.1f}]ms {share:>6.0%} "
            f"{p.throughput_sps:>8.0f} {_mb(p.mem_headroom_bytes):>9}  "
            f"{why(p, best, objective)}")
    return lines


def render_plan(picks: Sequence[Prediction],
                frontier: Sequence[Prediction],
                model, *, objective: str,
                n_space: int, n_feasible: int) -> str:
    """The plan as ``launch.plan`` prints it (the reference's
    ``benchmarks.plan`` text): what won, why, and under which
    calibration."""
    lines = [
        "== launch plan "
        f"(objective: {objective}; fixed-work unit: time to process "
        "128 samples) ==",
        f"  space: {n_space} points, {n_feasible} feasible, "
        f"{len(frontier)} on the Pareto frontier "
        "(time × device-seconds × memory headroom)",
        f"  {model.calibration_note()}; oversubscription width "
        f"k={model.oversub_k:g}; predictor MAPE vs measured rows "
        f"{model.band_mape:.1%} (band width)",
        "",
    ]
    lines += plan_lines(picks, objective)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Elastic-aware ranking table (benchmarks/ELASTIC.md)
# ---------------------------------------------------------------------------

def _pick_label(p: Prediction) -> str:
    pt = p.point
    return (f"{pt.strategy} @ {pt.n_devices} dev, batch {pt.batch_size}, "
            f"wire {pt.cfg.wire_bits}")


def render_elastic_table(preds: Sequence[Prediction], costs,
                         lambdas: Sequence[float]) -> List[str]:
    """Markdown rows: the elastic-aware top pick per failure rate λ.

    ``costs`` is a ``search.RestartCosts``; rows where the pick differs
    from the steady-state (λ=0) winner are flagged — the planner's
    decision genuinely depends on the failure regime there.
    """
    from repro_torch.perf.planner.search import (execution_key,
                                           expected_time_ms, rank_elastic)
    base = rank_elastic(preds, costs, 0.0)[0]
    lines = [
        "| λ (failures / device·hour) | elastic-aware top pick | "
        "expected ms | steady-state ms | restart overhead |",
        "|---|---|---|---|---|",
    ]
    for lam in lambdas:
        top = rank_elastic(preds, costs, lam)[0]
        exp = expected_time_ms(top, costs, lam)
        flip = execution_key(top) != execution_key(base)
        label = _pick_label(top) + (" **← pick flips**" if flip else "")
        lines.append(
            f"| {lam:g} | {label} | {exp:.1f} | {top.time_ms:.1f} | "
            f"{exp / max(top.time_ms, 1e-12) - 1.0:.1%} |")
    return lines


# ---------------------------------------------------------------------------
# PLANNER.md (validation report)
# ---------------------------------------------------------------------------

def render_validation_md(picks: Sequence[Prediction],
                         measured_ms: Sequence[float],
                         metrics: Dict[str, float], model, *,
                         objective: str, pool: int, n_space: int,
                         n_feasible: int, n_frontier: int,
                         protocol: str,
                         plan_text: Optional[str] = None,
                         roles: Optional[Sequence[str]] = None) -> str:
    """The predicted-vs-measured decision report ``launch.plan
    --validate`` writes where it is told."""
    meas = np.asarray(measured_ms, float)
    order = np.argsort(meas, kind="stable")
    meas_rank = {int(i): r + 1 for r, i in enumerate(order)}
    gate = "PASS" if metrics["top1_in_measured_top3"] else "FAIL"
    roles = list(roles) if roles is not None else ["pick"] * len(picks)
    n_picks = sum(1 for r in roles if r == "pick")
    n_probes = len(roles) - n_picks
    lines = [
        "# Planner validation: predicted vs measured launch rankings",
        "",
        f"Generated by `python -m repro_torch.launch.plan --validate` "
        f"over a world of {pool} ranks (`dist.pool.Pool`, gloo; under "
        f"cuda every rank shares the one card). "
        f"The planner enumerated {n_space} launch points "
        f"({n_feasible} feasible, {n_frontier} Pareto-optimal), "
        f"recommended a diverse top-{n_picks} slate by predicted "
        f"*{objective}* plus {n_probes} contrast probes from fixed "
        f"quantiles of the predicted ranking (for rank-metric dynamic "
        f"range), then executed every config for real through the "
        f"sharded LeNet iteration (`perf.sweep.make_sharded_iteration`, "
        f"compiled; {protocol}) and "
        f"scored its own ranking.",
        "",
        f"- {model.calibration_note()}",
        f"- compute model: generic expression fitted on the measured "
        f"sweep's compute target (held-out MAPE "
        f"{model.compute_mape:.1%}), queried at the per-device "
        f"sub-batch and scaled by the fitted pool oversubscription "
        f"(k={model.oversub_k:g}); predictor MAPE vs the measured rows "
        f"{model.band_mape:.1%} (the band column)",
        "",
        "## Decision quality",
        "",
        f"| metric | value |",
        f"|---|---|",
        f"| Kendall τ (predicted vs measured order) | "
        f"{metrics['kendall_tau']:+.3f} |",
        f"| top-1 regret | {metrics['top1_regret']:.1%} |",
        f"| top-1 measured rank | {metrics['top1_measured_rank']} of "
        f"{metrics['n']} |",
        f"| top-1 in measured top-3 (acceptance gate) | {gate} |",
        f"| prediction MAPE over the slate | {metrics['mape']:.1%} |",
        f"| prediction bias | {metrics['bias']:+.1%} |",
        "",
        "## Slate (predicted order)",
        "",
        "All times are fixed-work milliseconds — time to process 128 "
        "samples at the point's (batch, devices) — so rows with "
        "different batch sizes compare fairly.",
        "",
        "| # | role | strategy | devices | batch | wire bits | "
        "predicted ms (band) | measured ms | measured rank | "
        "dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, p in enumerate(picks):
        pt = p.point
        lines.append(
            f"| {i + 1} | {roles[i]} | {pt.strategy} | {pt.n_devices} | "
            f"{pt.batch_size} | {pt.cfg.wire_bits} | "
            f"{p.time_ms:.1f} [{p.lo_ms:.1f}, {p.hi_ms:.1f}] | "
            f"{meas[i]:.1f} | {meas_rank[i]} | {p.dominant_term} |")
    lines += [
        "",
        "Reading the table: the planner is scored on *decisions* — "
        "whether its preferred operating points are the ones that "
        "actually run fastest — not on absolute residuals. Ranks that "
        "share a card and a host's cores make absolute times noisy, "
        "which the band column and the MAPE row quantify; the ranking "
        "metrics above are the planner's real contract.", ""]
    if plan_text:
        lines += ["## Full plan output", "", "```", plan_text, "```", ""]
    return "\n".join(lines)
