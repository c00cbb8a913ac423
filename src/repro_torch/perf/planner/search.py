"""Search over predicted launch points: constraints, Pareto, top-k
(``repro.perf.planner.search``, copied: pure functions of predictions).

The planner's decision surface is three-dimensional (the axes the
ROADMAP's serve-at-scale scenarios trade between):

  * fixed-work time  — how fast the work gets done,
  * device-seconds   — how much hardware budget it burns doing it,
  * memory headroom  — how close to the per-device budget it sails.

``pareto_frontier`` keeps the non-dominated points of that surface;
``top_k`` ranks under a single objective after ``Constraints`` filters,
optionally diversified over (strategy, n_devices) cells so a validation
slate spans the space instead of clustering around near-ties.

The *elastic-aware* mode (``RestartCosts`` / ``expected_time_ms`` /
``rank_elastic``) prices failures into the ranking: at failure rate λ
(failures per device-hour) a pick's expected wall clock is its
steady-state time inflated by the fraction lost to restarts, with the
restart cost assembled from measured recovery terms (plan + compile +
restore; the defaults are the reference's drill on its host pool,
benchmarks/ELASTIC.md) plus replayed steps. Steady-state-best
and expected-best can disagree — a wider pool is faster per step but
restarts more often — which is the whole point of ranking on λ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.perf.planner.predict import Prediction

# objective name -> (key function, higher_is_better)
OBJECTIVES: Dict[str, Tuple[Callable[[Prediction], float], bool]] = {
    "time": (lambda p: p.time_ms, False),
    "step_time": (lambda p: p.step_ms, False),
    "throughput": (lambda p: p.throughput_sps, True),
    "efficiency": (lambda p: p.efficiency_sps_per_device, True),
    "device_seconds": (lambda p: p.device_seconds, False),
}


def objective_value(pred: Prediction, objective: str) -> float:
    key, _ = _objective(objective)
    return key(pred)


def _objective(name: str):
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown objective {name!r}; "
                         f"have {sorted(OBJECTIVES)}") from None


@dataclass(frozen=True)
class Constraints:
    """User-imposed limits applied before ranking."""
    max_devices: Optional[int] = None
    min_devices: Optional[int] = None
    min_batch: Optional[int] = None
    max_batch: Optional[int] = None
    max_time_ms: Optional[float] = None
    min_mem_headroom_bytes: int = 0
    strategies: Optional[Tuple[str, ...]] = None
    compressions: Optional[Tuple[str, ...]] = None

    def admits(self, p: Prediction) -> bool:
        pt = p.point
        if self.max_devices is not None and pt.n_devices > self.max_devices:
            return False
        if self.min_devices is not None and pt.n_devices < self.min_devices:
            return False
        if self.min_batch is not None and pt.batch_size < self.min_batch:
            return False
        if self.max_batch is not None and pt.batch_size > self.max_batch:
            return False
        if self.max_time_ms is not None and p.time_ms > self.max_time_ms:
            return False
        if p.mem_headroom_bytes < self.min_mem_headroom_bytes:
            return False
        if self.strategies is not None and pt.strategy not in self.strategies:
            return False
        if (self.compressions is not None
                and pt.compression not in self.compressions):
            return False
        return True

    def apply(self, preds: Sequence[Prediction]) -> List[Prediction]:
        return [p for p in preds if self.admits(p)]

    def to_dict(self) -> Dict:
        import dataclasses
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v not in (None, 0)}


def _pareto_axes(p: Prediction) -> Tuple[float, float, float]:
    """All-minimized coordinates: time, device-seconds, −headroom."""
    return (p.time_ms, p.device_seconds, -float(p.mem_headroom_bytes))


def pareto_frontier(preds: Sequence[Prediction]) -> List[Prediction]:
    """Non-dominated predictions over (time, device-seconds, headroom).

    A point is dominated when another is no worse on every axis and
    strictly better on at least one. O(n²) on a few hundred points.
    """
    axes = [_pareto_axes(p) for p in preds]
    keep: List[Prediction] = []
    for i, a in enumerate(axes):
        dominated = False
        for j, b in enumerate(axes):
            if j == i:
                continue
            if all(bv <= av for bv, av in zip(b, a)) and b != a:
                dominated = True
                break
            if b == a and j < i:            # exact ties: keep the first
                dominated = True
                break
        if not dominated:
            keep.append(preds[i])
    return sorted(keep, key=lambda p: p.time_ms)


def rank(preds: Sequence[Prediction], objective: str = "time"
         ) -> List[Prediction]:
    key, hi = _objective(objective)
    return sorted(preds, key=key, reverse=hi)


def top_k(preds: Sequence[Prediction], k: int, *,
          objective: str = "time",
          constraints: Optional[Constraints] = None,
          diverse_by: Optional[Tuple[str, ...]] = None
          ) -> List[Prediction]:
    """Best ``k`` under an objective, after constraints.

    ``diverse_by`` (e.g. ``("strategy", "n_devices")``) first takes the
    best point of each distinct feature cell, then fills the remainder
    by objective — the slate the validation protocol measures, so the
    measured ranking spans genuinely different operating points rather
    than k near-identical near-winners.
    """
    pool = list(preds) if constraints is None else constraints.apply(preds)
    ordered = rank(pool, objective)
    if not diverse_by:
        return ordered[:k]
    seen_cells = set()
    picks: List[Prediction] = []
    for p in ordered:
        cell = tuple(getattr(p.point, f) for f in diverse_by)
        if cell in seen_cells:
            continue
        seen_cells.add(cell)
        picks.append(p)
        if len(picks) == k:
            return picks
    chosen = {id(p) for p in picks}
    for p in ordered:
        if len(picks) == k:
            break
        if id(p) not in chosen:
            picks.append(p)
            chosen.add(id(p))
    # keep the slate ordered by the objective, not by insertion round
    return rank(picks, objective)


@dataclass(frozen=True)
class RestartCosts:
    """Per-recovery cost terms (ms), the defaults measured by the
    reference's elastic drill (not on the card: the port has no recovery
    path yet).

    ``compile_ms`` is the exposed (re-)compile at recovery: the ~2.7 s
    re-jit tail cold, near zero when survivor meshes were pre-compiled
    in the background (``repro.train.supervisor``). ``replay_steps`` is
    the expected number of steps lost since the last checkpoint
    (``checkpoint_every / 2`` under uniform failure arrival); each
    replayed step costs the pick's own predicted step time.
    """
    plan_ms: float = 50.0
    compile_ms: float = 2700.0
    restore_ms: float = 150.0
    replay_steps: float = 0.0

    @property
    def fixed_ms(self) -> float:
        """Restart cost independent of the pick's step time."""
        return self.plan_ms + self.compile_ms + self.restore_ms

    def restart_ms(self, pred: Prediction) -> float:
        return self.fixed_ms + self.replay_steps * pred.step_ms

    def to_dict(self) -> Dict:
        return {"plan_ms": self.plan_ms, "compile_ms": self.compile_ms,
                "restore_ms": self.restore_ms,
                "replay_steps": self.replay_steps}


def expected_time_ms(pred: Prediction, costs: RestartCosts,
                     failures_per_device_hour: float) -> float:
    """Expected fixed-work wall clock once failures are priced in.

    Failures arrive independently per device at rate λ (per
    device-hour), so over a window of wall clock T the expected restart
    count is ``λ · n_devices · T``; each restart costs
    ``costs.restart_ms(pred)``. To first order the expectation is the
    steady-state time scaled by the restart-overhead factor::

        E[T] = time_ms · (1 + λ · n_devices · restart_ms / 3.6e6)

    The factor is the *fraction of wall clock lost to restarts* — it is
    what inflates a long production run at this operating point, so
    ranking the fixed-work proxy by it ranks the production run too.
    """
    lam = float(failures_per_device_hour)
    if lam <= 0.0:
        return float(pred.time_ms)
    overhead = (lam * pred.point.n_devices
                * costs.restart_ms(pred) / 3.6e6)
    return float(pred.time_ms) * (1.0 + overhead)


def rank_elastic(preds: Sequence[Prediction], costs: RestartCosts,
                 failures_per_device_hour: float) -> List[Prediction]:
    """``rank(..., "time")`` with restart cost priced in at rate λ."""
    return sorted(preds, key=lambda p: expected_time_ms(
        p, costs, failures_per_device_hour))


def elastic_flip(preds: Sequence[Prediction], costs: RestartCosts,
                 lambdas: Sequence[float]) -> Optional[Dict]:
    """The first λ in ``lambdas`` where the elastic-aware top pick
    differs from the steady-state (λ=0) pick, or None if the ranking
    never flips over the scanned range."""
    if not preds:
        return None
    base = rank_elastic(preds, costs, 0.0)[0]
    for lam in lambdas:
        top = rank_elastic(preds, costs, lam)[0]
        if execution_key(top) != execution_key(base):
            return {"lambda": float(lam), "base": base, "flipped": top}
    return None


def execution_key(p: Prediction) -> Tuple:
    """What the measured path actually executes. At one device every
    strategy degenerates to the same single-device iteration (no
    collectives), so strategy is collapsed there — a validation slate
    must not spend measurements on duplicates of the same program."""
    pt = p.point
    strategy = pt.strategy if pt.n_devices > 1 else "single"
    return (strategy, pt.n_devices, pt.batch_size, pt.compression)


def validation_slate(preds: Sequence[Prediction], k: int, *,
                     objective: str = "time",
                     constraints: Optional[Constraints] = None
                     ) -> List[Prediction]:
    """The slate the validation protocol measures: diverse over
    (strategy, n_devices) cells like ``top_k``, additionally deduped by
    ``execution_key`` so every measurement is a distinct program."""
    pool = list(preds) if constraints is None else constraints.apply(preds)
    ordered = rank(pool, objective)
    picks: List[Prediction] = []
    cells, execs = set(), set()
    for p in ordered:
        cell = (p.point.strategy, p.point.n_devices)
        ek = execution_key(p)
        if cell in cells or ek in execs:
            continue
        cells.add(cell)
        execs.add(ek)
        picks.append(p)
        if len(picks) == k:
            break
    for p in ordered:                       # fill with distinct programs
        if len(picks) == k:
            break
        ek = execution_key(p)
        if ek not in execs:
            execs.add(ek)
            picks.append(p)
    return rank(picks, objective)


def probe_slate(preds: Sequence[Prediction], *,
                fractions: Sequence[float] = (0.35, 0.6, 0.8, 1.0),
                objective: str = "time",
                exclude: Sequence[Prediction] = ()) -> List[Prediction]:
    """Contrast probes for the validation protocol: points at fixed
    quantiles of the predicted ranking (1.0 = predicted worst).

    A slate of only near-optimal picks has almost no dynamic range, so
    rank agreement with the measurement would be dominated by noise;
    the probes stretch the slate across the predicted spectrum, which
    is what makes Kendall-τ a real test of the model's ordering.
    Duplicated executions (vs ``exclude`` and each other) are skipped.
    """
    ordered = rank(list(preds), objective)
    execs = {execution_key(p) for p in exclude}
    out: List[Prediction] = []
    for f in fractions:
        i = min(int(round(f * (len(ordered) - 1))), len(ordered) - 1)
        j = i
        while j < len(ordered) and execution_key(ordered[j]) in execs:
            j += 1
        if j == len(ordered):
            continue
        execs.add(execution_key(ordered[j]))
        out.append(ordered[j])
    return out
