"""Smoke for the calibration pipeline: a tiny sweep, then calibrate, then
the artifact's schema (``tools/calibration_smoke.py``).

  PYTHONPATH=src python -m repro_torch.tools.calibration_smoke [--out PATH] \\
      [--device cuda]

Runs a deterministic micro-sweep (every registry strategy × {2, 4}
devices, one compiled LeNet trial each, its sharded iteration measured on
a world of 4 ranks, ``dist.pool.Pool``, gloo, all on the card under
``cuda``), fits the link calibration from the residuals on ``--device``,
writes the JSON artifact to ``--out`` (by default a temporary path) and
asserts its schema, so the cost model cannot rot between full sweeps.

The reference's tool asserts schema version 1; its calibration writer has
written version 2 (the per-strategy overlap map) since, so the port holds
the version to the writer's ``SCHEMA_VERSION``.

Exit code 0 = artifact written and schema-valid. The last stdout line is a
JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

REQUIRED_TOP = {"version", "label", "default", "per_collective", "meta"}
REQUIRED_LINK = {"alpha_s", "bw_bytes_per_s"}
REQUIRED_META = {"n_rows", "mode", "mae_ms_default", "mae_ms_fitted"}
POOL = 4


def micro_sweep(pool, device) -> list:
    """One compiled trial for each strategy × {2, 4} devices, sharded on
    ``pool``; the rows."""
    from dataclasses import asdict

    from repro_torch.configs.lenet5 import DIST_STRATEGIES, LeNet5Config
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
    from repro_torch.perf.sweep import measure_trial

    rows = []
    for strategy in DIST_STRATEGIES:
        for n in (2, 4):
            cfg = LeNet5Config(n_devices=n, batch_size=16,
                               strategy=strategy, compression="int8",
                               optimizer="sgd", n_filters=8)
            row = asdict(measure_trial(cfg, "jit", n_iters=1, seed=n,
                                       sharded=True, device=device, pool=pool,
                                       calibration=DEFAULT_CALIBRATION))
            assert row["t_measured_sharded"] is not None, (strategy, n, row)
            rows.append(row)
    return rows


def check_artifact(path: str) -> dict:
    """The written calibration's schema, and its load through the public
    loader; returns the blob."""
    from repro_torch.perf.costmodel import Calibration
    from repro_torch.perf.costmodel.calibrate import SCHEMA_VERSION
    with open(path) as f:
        blob = json.load(f)
    assert REQUIRED_TOP <= set(blob), blob.keys()
    assert REQUIRED_LINK <= set(blob["default"]), blob["default"]
    assert REQUIRED_META <= set(blob["meta"]), blob["meta"]
    assert blob["version"] == SCHEMA_VERSION
    for lk in (blob["per_collective"] or {}).values():
        assert REQUIRED_LINK <= set(lk), lk
    back = Calibration.load(path)
    assert back.default.alpha_s > 0 and back.default.bw_bytes_per_s > 0
    return blob


def main(argv=None, pool=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "comm_calibration_smoke.json"))
    ap.add_argument("--maxiter", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="the trials', the ranks' and the fit's device (the card "
                         "unless cpu)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.dist.pool import Pool
    from repro_torch.perf.costmodel import fit_calibration

    dev = resolve_device(args.device)
    t0 = time.time()
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=POOL, device=dev)) as p:
        rows = micro_sweep(p, dev)
    print(f"micro-sweep: {len(rows)} rows in {time.time()-t0:.0f}s", flush=True)

    cal = fit_calibration(rows, per_collective=True, seeds=(0,),
                          maxiter=args.maxiter, source="calibration_smoke",
                          device=dev)
    cal.save(args.out)
    blob = check_artifact(args.out)

    print(json.dumps({"ok": True, "out": args.out,
                      "n_rows": blob["meta"]["n_rows"],
                      "mae_ms_default": blob["meta"]["mae_ms_default"],
                      "mae_ms_fitted": blob["meta"]["mae_ms_fitted"],
                      "wall_s": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
