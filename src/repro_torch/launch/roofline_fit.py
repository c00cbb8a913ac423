"""The generic performance model fitted to the dry-run's roofline rows, and
the launcher hooks it serves: mesh ranking, the straggler threshold and the
chips-scaling power (``benchmarks/roofline_fit.py``).

  PYTHONPATH=src python -m repro_torch.launch.roofline_fit \\
      [--results-dir benchmarks/dryrun_results_torch] [--device cuda]

The fit runs by differential evolution on ``--device`` (the card unless
``--device cpu``). Its rows are the port's (``launch.dryrun``), whose
accounting ``launch.roofline_table`` describes: the fit reports what those
rows give and is not a result to gate on.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.launch.common import DRYRUN_DIR, emit


def roofline_fit(results_dir: str = DRYRUN_DIR, device="cuda") -> dict:
    if not os.path.isdir(results_dir) or not any(
            f.endswith(".json") for f in os.listdir(results_dir)):
        emit("roofline_fit", status="SKIP",
             reason="no dryrun results (run python -m repro_torch.launch.dryrun --all)")
        return {"status": "SKIP"}
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.predictor import StepTimePredictor

    try:
        pred = StepTimePredictor.fit_from_dryrun(results_dir, seeds=(0, 1, 2),
                                                 device=device)
    except ValueError as e:
        emit("roofline_fit", status="SKIP", reason=str(e))
        return {"status": "SKIP"}
    fr = pred.fit_result
    emit("roofline_fit", status="OK",
         train_mape=f"{fr.train_metrics['mape']:.3f}",
         r2=f"{fr.train_metrics['r2']:.3f}",
         q_chips=f"{pred.scaling_power_chips():+.3f}")

    # launcher hook demos
    cfg, shape = get_config("qwen2.5-3b"), get_shape("train_4k")
    ranked = pred.rank_meshes(cfg, shape, [64, 128, 256, 512])
    emit("mesh_ranking", arch="qwen2.5-3b", shape="train_4k",
         best=f"{ranked[0][0]}chips",
         order="|".join(str(n) for n, _ in ranked))
    thr = pred.straggler_threshold(cfg, shape, 256)
    emit("straggler_threshold", arch="qwen2.5-3b", chips=256,
         threshold_s=f"{thr:.3f}")
    return {"status": "OK", "q_chips": pred.scaling_power_chips(),
            "ranked": ranked, "metrics": fr.train_metrics,
            "straggler_threshold_s": thr}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results-dir", default=DRYRUN_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fit (the card unless cpu)")
    args = ap.parse_args(argv)
    return roofline_fit(args.results_dir, args.device)


if __name__ == "__main__":
    main()
