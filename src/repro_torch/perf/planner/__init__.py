"""The scenario planner (``repro.perf.planner``): the fitted model inverted
into launch recommendations.

The decision layer over the two fitted artifacts, the generic performance
model and the calibrated collective cost model, that turns "here is how
time scales" into "launch this":

  space    enumerate the feasible (strategy × devices × batch × wire
           format) grid with the registry's divisibility and axis rules and
           a per-rank memory estimate
  predict  vectorized time, throughput and efficiency per point: a fitted
           compute term and a calibrated comm term, with bands from the fit
           residuals
  search   Pareto frontier over time × device-seconds × memory headroom,
           constrained top-k picks, the validation slate, elastic ranking
  report   why each pick won, which term dominates, and the
           predicted-vs-measured ranking metrics (Kendall τ, top-1 regret)
  auto     ``launch.train --strategy auto``

Entry points: ``python -m repro_torch.launch.plan`` (``--dry-run``,
``--refit``, ``--validate``) and ``python -m repro_torch.launch.train
--strategy auto --report-comm``.
"""
from repro_torch.perf.planner.auto import (StrategyDecision, choose_strategy,
                                           remesh_predict)
from repro_torch.perf.planner.predict import (PlannerModel, Prediction,
                                              UNCALIBRATED_NOTE,
                                              default_model_path,
                                              fit_planner_model,
                                              predict_points)
from repro_torch.perf.planner.report import (kendall_tau, plan_lines,
                                             ranking_metrics,
                                             render_elastic_table,
                                             render_plan,
                                             render_validation_md)
from repro_torch.perf.planner.search import (Constraints, OBJECTIVES,
                                             RestartCosts, elastic_flip,
                                             execution_key, expected_time_ms,
                                             objective_value, pareto_frontier,
                                             rank, rank_elastic, top_k,
                                             validation_slate)
from repro_torch.perf.planner.space import (ArchLaunchPoint,
                                            DEFAULT_MEM_BUDGET_BYTES,
                                            Feasibility, LaunchPoint,
                                            MemoryEstimate, check_feasible,
                                            check_feasible_model,
                                            enumerate_lenet_space,
                                            enumerate_space, estimate_memory,
                                            estimate_memory_for, lenet_memory,
                                            model_comm_sizes, model_memory,
                                            shard_divisor, tree_shard_bytes)

__all__ = [
    "ArchLaunchPoint", "Constraints", "DEFAULT_MEM_BUDGET_BYTES",
    "Feasibility", "LaunchPoint", "MemoryEstimate", "OBJECTIVES",
    "PlannerModel", "Prediction", "RestartCosts", "StrategyDecision",
    "UNCALIBRATED_NOTE",
    "check_feasible", "check_feasible_model", "choose_strategy",
    "default_model_path", "elastic_flip", "enumerate_lenet_space",
    "enumerate_space",
    "estimate_memory", "estimate_memory_for", "expected_time_ms",
    "fit_planner_model",
    "kendall_tau", "lenet_memory", "execution_key", "model_comm_sizes",
    "model_memory", "objective_value", "pareto_frontier", "plan_lines",
    "predict_points", "rank", "rank_elastic", "ranking_metrics",
    "remesh_predict",
    "render_elastic_table", "render_plan",
    "render_validation_md", "shard_divisor", "top_k", "tree_shard_bytes",
    "validation_slate",
]
