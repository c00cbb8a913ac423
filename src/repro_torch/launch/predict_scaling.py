"""The paper's model as a launcher feature (``examples/predict_scaling.py``):
fit on dry-run roofline cells, predict step time for unseen mesh sizes,
rank candidate meshes, and derive a straggler threshold.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.predict_scaling \\
      --results-dir benchmarks/dryrun_results_torch

The fit's DE runs on ``--device`` (the card by default). Without dry-run
rows in ``--results-dir`` it says how to make them and exits 0, as the
reference's example does.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

from repro_torch.launch.dryrun import DEFAULT_OUTDIR

ARCHS = ("qwen2.5-3b", "deepseek-v3-671b", "mamba2-370m")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results-dir", default=DEFAULT_OUTDIR)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """Prints the fit and the predictions; returns them as numbers."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.predictor import StepTimePredictor

    args = build_parser().parse_args(argv)
    d = args.results_dir
    if not (os.path.isdir(d) and any(f.endswith(".json") and f != "summary.json"
                                     for f in os.listdir(d))):
        print("no dry-run results found — run:\n"
              "  PYTHONPATH=src python -m repro_torch.launch.dryrun --all\n"
              "then re-run this entry point.")
        return {}
    pred = StepTimePredictor.fit_from_dryrun(d, seeds=(0, 1, 2), device=args.device)
    print(pred.fit_result.summary())
    q = pred.scaling_power_chips()
    print(f"fitted chips-scaling power: q = {q:+.3f}  (-1 would be ideal)")
    out = {"q_chips": q, "train_mape": pred.fit_result.train_metrics["mape"],
           "archs": {}}
    for arch in ARCHS:
        cfg, shape = get_config(arch), get_shape("train_4k")
        t256 = pred.predict_step_seconds(cfg, shape, 256)
        t512 = pred.predict_step_seconds(cfg, shape, 512)
        thr = pred.straggler_threshold(cfg, shape, 256)
        print(f"{arch:22s} train_4k: 256 chips {t256:7.3f}s -> "
              f"512 chips {t512:7.3f}s  "
              f"(speedup x{t256 / max(t512, 1e-9):.2f})")
        print(f"{'':22s} straggler threshold (tol 1.5): {thr:.3f}s")
        out["archs"][arch] = {"t256_s": t256, "t512_s": t512, "straggler_s": thr}
    return out


if __name__ == "__main__":
    main()
