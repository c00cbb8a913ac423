"""StepTimePredictor: the paper's model as a runtime framework feature
(``repro.core.predictor``).

Fits the generic expression to (arch × shape × mesh) roofline cells that
the dry-run (``launch.dryrun``) wrote, with

  I = {n_layers, d_model, d_ff_eff, n_heads, head_dim, active params,
       family (categorical), mode (categorical)}
  E = {chips, tokens (= batch·seq, or batch for decode)}

and then serves three launcher hooks:
  * ``predict_step_seconds``: ETA / throughput reporting
  * ``straggler_threshold``: a straggler detector's per-step bound
  * ``rank_meshes``: ranks candidate mesh sizes without tracing each

The rows' keys are the reference's, so either package's rows fit here.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fit import FitResult, fit_model
from repro_torch.core.generic_model import FeatureSpec, PerfModel

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

CELL_SPEC = FeatureSpec(
    numeric=("n_layers", "d_model", "d_ff_eff", "n_heads", "head_dim",
             "active_params_b"),
    categorical=(("family", FAMILIES), ("mode", ("train", "prefill",
                                                 "decode"))),
    extrinsic=("chips", "tokens_m"),
)


def cell_features(cfg: ModelConfig, shape: ShapeConfig,
                  n_chips: int) -> Dict:
    d_ff_eff = cfg.d_ff
    if cfg.moe is not None:
        d_ff_eff = max(cfg.moe.top_k * cfg.moe.d_ff_expert, 1)
    if cfg.family == "ssm":
        d_ff_eff = cfg.ssm.expand * cfg.d_model
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.mode in ("train", "prefill")
                                   else 1)
    return {
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "d_ff_eff": d_ff_eff,
        "n_heads": cfg.n_heads,
        "head_dim": cfg.get_head_dim(),
        "active_params_b": max(cfg.param_count(active_only=True) / 1e9,
                               1e-3),
        "family": cfg.family,
        "mode": shape.mode,
        "chips": n_chips,
        "tokens_m": max(tokens / 1e6, 1e-6),
    }


def dryrun_samples(results_dir: str) -> Tuple[List[Dict], List[float]]:
    """(features, roofline t_step) of every OK row in ``results_dir``."""
    from repro_torch.configs import get_config, get_shape
    samples, times = [], []
    for name in sorted(os.listdir(results_dir)):
        if not name.endswith(".json") or name == "summary.json":
            continue
        with open(os.path.join(results_dir, name)) as f:
            row = json.load(f)
        if row.get("status") != "OK":
            continue
        samples.append(cell_features(get_config(row["arch"]),
                                     get_shape(row["shape"]), row["n_chips"]))
        times.append(row["roofline"]["t_step"])
    return samples, times


@dataclass
class StepTimePredictor:
    model: Optional[PerfModel] = None
    fit_result: Optional[FitResult] = None

    # -- fitting --------------------------------------------------------------
    @classmethod
    def fit_from_dryrun(cls, results_dir: str, *, reg: str = "l2",
                        lam: float = 1e-3, seeds=tuple(range(5)),
                        maxiter: int = 300, device="cuda") -> "StepTimePredictor":
        """Fit on every OK row of ``results_dir`` (at least 8), the DE on
        ``device``."""
        samples, times = dryrun_samples(results_dir)
        if len(samples) < 8:
            raise ValueError(f"too few dry-run cells ({len(samples)})")
        fr = fit_model(CELL_SPEC, samples, times, reg=reg, lam=lam,
                       seeds=seeds, maxiter=maxiter, device=device)
        return cls(model=fr.model, fit_result=fr)

    # -- launcher hooks ---------------------------------------------------------
    # Predictions route through the shared feature→time path
    # (perf.predict.predict_samples), the one the LeNet sweep's fits and
    # the scenario planner's search use.
    def predict_step_seconds(self, cfg: ModelConfig, shape: ShapeConfig,
                             n_chips: int) -> float:
        from repro_torch.perf.predict import predict_samples
        f = cell_features(cfg, shape, n_chips)
        return float(predict_samples(self.model, [f])[0])

    def straggler_threshold(self, cfg, shape, n_chips,
                            tolerance: float = 1.5) -> float:
        return tolerance * self.predict_step_seconds(cfg, shape, n_chips)

    def rank_meshes(self, cfg: ModelConfig, shape: ShapeConfig,
                    candidates: Sequence[int]) -> List[Tuple[int, float]]:
        """Rank chip counts (or mesh sizes) by predicted step time: one
        vectorized prediction over all candidates."""
        from repro_torch.perf.predict import predict_samples
        samples = [cell_features(cfg, shape, n) for n in candidates]
        times = predict_samples(self.model, samples)
        return sorted(zip(candidates, (float(t) for t in times)),
                      key=lambda kv: kv[1])

    def scaling_power_chips(self) -> float:
        """Fitted q for the chips axis (q = -1: ideal scaling)."""
        return self.model.scaling_powers()["chips"][0]
