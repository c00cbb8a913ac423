"""Fault tolerance: straggler detection and elastic re-mesh planning
(``repro.train.ft``, copied).

The straggler detector is where the performance model becomes a runtime
feature: a hook (the fitted model's expected step time) sets the
expectation, and a measured step over ``tolerance ×`` it is flagged; without
the hook (or when it fails) a running median × tolerance rule stands in.

The elastic planner chooses a replacement mesh when ranks are lost: the
model axis as large as memory requires, the rest to data parallelism,
preferring shapes whose predicted step time is smallest.
``launch.mesh`` re-exports ``plan_remesh`` and ``ElasticPlan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class StragglerDetector:
    tolerance: float = 1.5           # flag if measured > tol * expected
    window: int = 32                 # running-median window
    predict_s: Optional[Callable[[], float]] = None   # perf-model hook
    history: List[float] = field(default_factory=list)
    flags: List[int] = field(default_factory=list)

    def expected(self) -> Optional[float]:
        if self.predict_s is not None:
            try:
                p = float(self.predict_s())
                if math.isfinite(p) and p > 0:
                    return p
            except Exception:
                pass
        if len(self.history) >= 5:
            h = sorted(self.history[-self.window:])
            return h[len(h) // 2]
        return None

    def observe(self, step: int, seconds: float) -> bool:
        exp = self.expected()
        is_straggler = exp is not None and seconds > self.tolerance * exp
        self.history.append(seconds)
        if is_straggler:
            self.flags.append(step)
        return is_straggler


def _factorizations(n: int) -> List[Tuple[int, int]]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append((d, n // d))
            if d != n // d:
                out.append((n // d, d))
        d += 1
    return sorted(out)


@dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    reason: str

    def axes(self) -> dict:
        """{axis: size}, as ``Pool.run`` takes a mesh."""
        return dict(zip(self.axis_names, self.mesh_shape))


def plan_remesh(n_devices: int, *, min_model: int = 1,
                max_model: Optional[int] = None,
                predict: Optional[Callable[[int, int], float]] = None,
                prefer_pow2: bool = True) -> ElasticPlan:
    """Choose (data, model) for a shrunk or grown set of ranks.

    ``min_model`` is the memory floor on the model axis, ``max_model`` its
    ceiling; ``predict(data, model) -> seconds`` ranks the feasible shapes
    (``perf.planner.remesh_predict``). Without it: the most square
    factorization with the model axis in bounds (4 → (2, 2), 8 → (2, 4)).
    ``prefer_pow2`` first rounds the count down to a power of two."""
    if prefer_pow2 and n_devices > 1:
        n_devices = 2 ** int(math.floor(math.log2(n_devices)))
    cands = [(d, m) for d, m in _factorizations(n_devices)
             if m >= min_model and (max_model is None or m <= max_model)]
    if not cands:
        cands = [(1, n_devices)]
    if predict is not None:
        best = min(cands, key=lambda dm: predict(dm[0], dm[1]))
        reason = "perf-model ranked"
    else:
        best = min(cands, key=lambda dm: abs(math.log2(max(dm[0], 1))
                                             - math.log2(max(dm[1], 1))))
        reason = "most-square fallback"
    return ElasticPlan(best, ("data", "model"), reason)


@dataclass
class RecoveryPlan:
    """What a failure recovery executes: the strategy on the surviving
    ranks, and the mesh factorization it runs on."""
    strategy: str
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int                     # ranks the new mesh uses
    reason: str
    decision: Optional[object] = None  # planner StrategyDecision, if any

    def axes(self) -> dict:
        return dict(zip(self.axis_names, self.mesh_shape))

    def to_dict(self) -> dict:
        out = {"strategy": self.strategy, "mesh": list(self.mesh_shape),
               "axis_names": list(self.axis_names),
               "devices": self.n_devices, "reason": self.reason}
        if self.decision is not None:
            out["planner"] = self.decision.to_dict()
        return out


def _model_axis_bounds(strategy: str, n: int) -> Tuple[int, Optional[int]]:
    """The registry strategies' mesh constraints: dp and fsdp shard over
    "data" only (a model axis above 1 would idle ranks); the tp family needs
    a real model axis."""
    if strategy in ("dp", "fsdp"):
        return 1, 1
    return (2, None) if n >= 2 else (1, None)


def plan_recovery(cfg, n_devices: int, *, batch: int, seq: int,
                  optimizer: str = "adamw", compression: str = "none",
                  strategy: Optional[str] = None,
                  compute_ref: Optional[Tuple[float, int]] = None,
                  mem_budget_bytes: Optional[int] = None,
                  calibration=None,
                  choose: Optional[Callable] = None,
                  make_predict: Optional[Callable] = None) -> RecoveryPlan:
    """The post-failure (strategy, mesh) for a shrunken set of ranks:
    ``perf.planner.choose_strategy`` ranks the registry for the surviving
    count rounded down to a power of two (unless ``strategy`` forces one),
    and ``plan_remesh`` ranks the (data, model) factorizations under
    ``perf.planner.remesh_predict`` (calibrated collective cost plus a
    compute term from ``compute_ref = (measured step seconds, data
    width)``; infeasible shapes price to ``inf``). ``choose`` and
    ``make_predict`` stand in for those two (tests)."""
    n = int(n_devices)
    n_eff = 2 ** int(math.floor(math.log2(n))) if n > 1 else max(n, 1)
    extra = {}
    if mem_budget_bytes is not None:
        extra["mem_budget_bytes"] = mem_budget_bytes
    if calibration is not None:
        extra["calibration"] = calibration

    decision = None
    if strategy is None:
        if choose is None:
            from repro_torch.perf.planner.auto import choose_strategy as choose
        decision = choose(cfg, batch=batch, seq=seq, n_devices=n_eff,
                          optimizer=optimizer, compression=compression, **extra)
        strategy = decision.strategy

    if make_predict is None:
        from repro_torch.perf.planner.auto import remesh_predict as make_predict
    predict = make_predict(cfg, strategy, batch=batch, seq=seq,
                           optimizer=optimizer, compression=compression,
                           compute_ref=compute_ref, **extra)

    min_model, max_model = _model_axis_bounds(strategy, n_eff)
    plan = plan_remesh(n_eff, min_model=min_model, max_model=max_model,
                       predict=predict)
    used = 1
    for s in plan.mesh_shape:
        used *= int(s)
    reason = f"strategy={strategy}"
    if decision is not None:
        reason += f" ({decision.reason})"
    reason += f"; mesh {plan.reason}"
    return RecoveryPlan(strategy=strategy, mesh_shape=plan.mesh_shape,
                        axis_names=plan.axis_names, n_devices=used,
                        reason=reason, decision=decision)


def survivors(n_devices: int, n_lost: int) -> int:
    """The ranks left when ``n_lost`` of ``n_devices`` die (at least one):
    the surviving prefix, renumbered contiguously, as ``launch.train`` rebuilds
    its mesh on them."""
    return max(int(n_devices) - max(int(n_lost), 0), 1)
