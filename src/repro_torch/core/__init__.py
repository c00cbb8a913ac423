"""The paper's contribution: a generic performance model for distributed DL
(``repro.core``).

  t(I, E, x) = ( Σ_i a_i I_i^{p_i} ) · ( Π_j E_j^{q_j} ) + C        (eq. 4)

fitted to measured iteration times by differential evolution (eq. 8) with
optional L1/L2 regularization (eqs. 10–11).

Submodules:
  generic_model — feature spec, encoding, the expression (float32 tensors)
  de            — differential evolution over a population tensor (+ Adam polish)
  fit           — fitting pipeline: multi-seed, torch or scipy backend
  baselines     — black-box comparators (Random Forest, ε-SVR), numpy
  interpret     — paper-style tables (2/3/6) and scaling analysis
  predictor     — the model fitted to dry-run cells as launcher hooks
"""
from repro_torch.core.de import differential_evolution_torch
from repro_torch.core.fit import FitResult, fit_model
from repro_torch.core.generic_model import (FeatureSpec, PerfModel,
                                            encode_dataset, predict_times)

__all__ = ["FeatureSpec", "PerfModel", "encode_dataset", "predict_times",
           "FitResult", "fit_model", "differential_evolution_torch"]
