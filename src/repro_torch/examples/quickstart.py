"""Quickstart (``examples/quickstart.py``): fit the paper's generic
performance model on synthetic data whose true law is known, inspect the
fitted constants, and check the scalability interpretation.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda]

The fit's differential evolution runs on ``--device`` (the card unless
``cpu``). ``--samples`` is the fit split's size, the test split two thirds
of it (the paper's 900 / 600 by default).
"""
import argparse

import numpy as np

from repro_torch.core import FeatureSpec, fit_model
from repro_torch.core.interpret import format_table, scaling_report


IDEAL_TOL = 0.15        # the example's assertion: q_gpus within this of -1


def fit(samples: int = 900, device="cuda"):
    """The generic model fitted by DE on ``device`` to ``samples`` draws of
    the synthetic law below (and tested on two thirds as many)."""
    rng = np.random.default_rng(0)

    # A workload whose execution time we pretend to measure:
    #   t = (4·k² + 0.3·f^1.5 + a_opt) · gpus^-1 · batch^-0.9 + 1.5
    spec = FeatureSpec(
        numeric=("kernel", "filters"),
        categorical=(("optimizer", ("sgd", "adam")),),
        extrinsic=("gpus", "batch"),
    )

    def true_time(s):
        a = {"sgd": 4.0, "adam": 9.0}[s["optimizer"]]
        t_i = 4 * s["kernel"] ** 2 + 0.3 * s["filters"] ** 1.5 + a
        return t_i * s["gpus"] ** -1.0 * s["batch"] ** -0.9 + 1.5

    def sample(n):
        xs = [dict(kernel=int(rng.choice([2, 3, 4, 5])),
                   filters=int(rng.choice([4, 8, 16, 32, 64])),
                   optimizer=str(rng.choice(["sgd", "adam"])),
                   gpus=int(rng.choice([1, 2, 4, 8])),
                   batch=int(rng.choice([8, 16, 32, 64])))
              for _ in range(n)]
        ts = [true_time(s) * (1 + 0.02 * rng.normal()) for s in xs]
        return xs, ts

    train_s, train_t = sample(samples)      # paper's split
    test_s, test_t = sample(samples * 2 // 3)

    return fit_model(spec, train_s, train_t, test_samples=test_s,
                     test_times=test_t, reg="l2", lam=1e-3,
                     seeds=range(5), maxiter=300, device=device)


def recovered(result) -> bool:
    """The example's claim: the fitted q_gpus (mean over the seeds) within
    ``IDEAL_TOL`` of -1."""
    return abs(result.model.scaling_powers()["gpus"][0] + 1.0) < IDEAL_TOL


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fit (the card unless cpu)")
    ap.add_argument("--samples", type=int, default=900,
                    help="fit samples; the test split is two thirds as many")
    args = ap.parse_args(argv)
    result = fit(args.samples, args.device)
    print(result.summary())
    print(format_table(result.model, "fitted constants (L2, λ=1e-3)"))
    print(scaling_report(result.model))
    assert recovered(result), "should recover ideal scaling"
    print("\nOK: recovered q_gpus ≈ -1 (ideal data-parallel scaling)")
    return result


if __name__ == "__main__":
    main()
