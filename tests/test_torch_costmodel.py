"""Port parity: the α-β collective cost model, the calibration it loads and
fits, and the shared prediction path against ``repro.perf.costmodel`` and
``repro.perf.predict``.

The schedules are float arithmetic in Python on both sides, so estimates
are held to equality (``==``). The calibration fit runs the port's DE on
the CPU; it is held to the planted link within the reference test's
bounds (25 % in log space), not to the reference's fitted numbers, since
the DE draws differ.
"""
import json
import math
import os

import numpy as np
import pytest

from repro.dist.sharding import STRATEGIES as JAX_STRATEGIES
from repro.dist.sharding import STRATEGY_COLLECTIVES as JAX_COLLECTIVES
from repro.perf import costmodel as JC
from repro.perf.predict import estimate_comm as jax_estimate_comm
from repro_torch.dist.sharding import (STRATEGIES, STRATEGY_COLLECTIVES,
                                       resolve_strategy)
from repro_torch.perf import costmodel as TC
from repro_torch.perf.costmodel.calibrate import (calibration_rows,
                                                  dataset_mae_s,
                                                  fit_family_calibrations,
                                                  link_transfer_matrix)
from repro_torch.perf.predict import estimate_comm, predict_samples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "benchmarks", "artifacts")


def test_strategy_registry_equal():
    assert list(STRATEGIES) == list(JAX_STRATEGIES)
    for name, s in STRATEGIES.items():
        ref = JAX_STRATEGIES[name]
        assert (s.name, dict(s.rules), s.description) == \
            (ref.name, dict(ref.rules), ref.description)
        assert [vars(d) for d in STRATEGY_COLLECTIVES[name]] == \
            [vars(d) for d in JAX_COLLECTIVES[name]]
    assert resolve_strategy("tp") is STRATEGIES["tp"]
    with pytest.raises(ValueError, match="unknown strategy"):
        resolve_strategy("pp")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_estimate_comm_equal(strategy, n):
    """Every wire width and two activation footprints, under the shared
    (checked-in) calibration and under the documented defaults."""
    for bits in (32, 16, 8):
        for act in (0, 3_276_800):
            for port_cal, ref_cal in ((None, None), (TC.DEFAULT_CALIBRATION,
                                                     JC.DEFAULT_CALIBRATION)):
                got = estimate_comm(strategy, n, 1_234_568, wire_bits=bits,
                                    act_bytes=act, compute_seconds=0.002,
                                    calibration=port_cal, detail=True)
                want = jax_estimate_comm(strategy, n, 1_234_568,
                                         wire_bits=bits, act_bytes=act,
                                         compute_seconds=0.002,
                                         calibration=ref_cal, detail=True)
                assert got.to_dict() == want.to_dict()
                assert got.seconds == want.seconds
                assert got.calibrated == want.calibrated


def test_load_calibration_of_the_checked_in_artifact_equal(monkeypatch):
    monkeypatch.delenv("REPRO_CALIBRATION", raising=False)
    assert TC.default_calibration_path() == JC.default_calibration_path()
    assert os.path.exists(TC.default_calibration_path())
    got, want = TC.load_calibration(), JC.load_calibration()
    assert got.to_dict() == want.to_dict()
    assert got.label == want.label != "default"


def test_load_calibration_env_and_fail_soft(monkeypatch, tmp_path):
    for value in ("", "none", "default"):
        monkeypatch.setenv("REPRO_CALIBRATION", value)
        assert TC.load_calibration() is TC.DEFAULT_CALIBRATION
        assert JC.load_calibration().label == "default"
    cal = TC.Calibration(label="fitted:test",
                         default=TC.LinkParams(3e-5, 2e9),
                         per_collective={"all_gather": TC.LinkParams(1e-5, 5e9)},
                         overlap={"fsdp": 0.25}, meta={"n_rows": 3})
    path = str(tmp_path / "cal.json")
    cal.save(path)
    monkeypatch.setenv("REPRO_CALIBRATION", path)
    assert TC.load_calibration().to_dict() == cal.to_dict()
    assert JC.load_calibration().to_dict() == cal.to_dict()
    missing = str(tmp_path / "missing.json")
    monkeypatch.setenv("REPRO_CALIBRATION", missing)
    with pytest.warns(UserWarning, match="does not exist"):
        assert TC.load_calibration().label == "default"
    with pytest.raises(FileNotFoundError):
        TC.load_calibration(strict=True)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99}))
    with pytest.warns(UserWarning, match="failed to load"):
        assert TC.load_calibration(str(bad)).label == "default"


def _synthetic_rows(link, compute_ms=5.0):
    """Sweep-row dicts whose measured-minus-compute residual is exactly the
    schedule under ``link`` (tests/test_costmodel.py's construction)."""
    rows = []
    for strategy in STRATEGIES:
        for n in (2, 4, 8):
            for pb in (250_000, 1_000_000, 4_000_000):
                inp = TC.ScheduleInputs(n_devices=n, param_bytes=pb,
                                        wire_bits=8, act_bytes=pb // 4)
                comm_ms = TC.strategy_comm_seconds(strategy, inp, link) * 1e3
                rows.append({
                    "features": {"strategy": strategy, "n_devices": n,
                                 "batch_size": 32, "wire_bits": 8},
                    "mode": "jit", "param_bytes": pb, "act_bytes": pb // 4,
                    "measured_ms": compute_ms, "comm_ms": comm_ms,
                    "time_ms": compute_ms + comm_ms,
                    "t_simulated": compute_ms + comm_ms,
                    "t_measured_sharded": compute_ms + comm_ms,
                    "sharded_skip": None, "calibration": "synthetic"})
    return rows


@pytest.mark.parametrize("log_alpha,log_bw", [(-4.5, 9.5), (-3.0, 7.5),
                                              (-3.7, 8.6)])
def test_fit_calibration_recovers_planted_link(log_alpha, log_bw):
    true = TC.LinkParams(alpha_s=10.0 ** log_alpha,
                         bw_bytes_per_s=10.0 ** log_bw)
    rows = _synthetic_rows(true)
    cal = TC.fit_calibration(rows, seeds=(0,), maxiter=150, device="cpu")
    got = cal.default
    assert abs(math.log10(got.alpha_s) - log_alpha) < 0.25 * abs(log_alpha)
    assert abs(math.log10(got.bw_bytes_per_s) - log_bw) < 0.25 * log_bw
    ok = calibration_rows(rows)
    assert dataset_mae_s(ok, cal.links()) <= dataset_mae_s(
        ok, TC.DEFAULT_LINK) + 1e-12


def test_per_collective_overlap_fit_and_resimulate():
    rows = _synthetic_rows(TC.LinkParams(alpha_s=2e-4, bw_bytes_per_s=5e8))
    cal = TC.fit_calibration(rows, per_collective=True, overlap=True,
                             seeds=(0,), maxiter=60, label="test-cal",
                             device="cpu")
    assert cal.label == "test-cal" and cal.meta["mode"] == "per_collective+overlap"
    assert set(cal.per_collective) == {"all_reduce", "reduce_scatter",
                                       "all_gather"}
    assert set(cal.overlap) == set(STRATEGIES)
    assert all(0.0 <= r <= 1.0 for r in cal.overlap.values())
    ref_cal = JC.Calibration.from_dict(cal.to_dict())
    assert TC.resimulate_rows(rows, cal) == JC.resimulate_rows(rows, ref_cal)


def test_family_calibrations_and_transfer_matrix_price_like_the_reference():
    rows = {f: json.load(open(os.path.join(ART, f"arch_sweep_{f}.json")))
            for f in ("lm", "ssm")}
    cals = fit_family_calibrations(rows, seeds=(0,), maxiter=40,
                                   device="cpu")
    assert set(cals) == {"lm", "ssm"}
    ref = {f: JC.Calibration.from_dict(c.to_dict()) for f, c in cals.items()}
    from repro.perf.costmodel.calibrate import \
        link_transfer_matrix as jax_transfer
    assert link_transfer_matrix(rows, cals) == jax_transfer(rows, ref)


def test_predict_samples_band():
    from repro_torch.core.generic_model import FeatureSpec, PerfModel
    spec = FeatureSpec(numeric=("k",), categorical=(), extrinsic=("g",))
    model = PerfModel(spec, np.array([2.0, 1.0, -1.0, 0.5]), device="cpu")
    samples = [dict(k=1, g=1), dict(k=3, g=2)]
    mean = predict_samples(model, samples)
    np.testing.assert_allclose(mean, [2.5, 3.5], rtol=1e-6)
    m, lo, hi = predict_samples(model, samples, rel_band=0.1)
    np.testing.assert_allclose(lo, 0.9 * mean, rtol=1e-6)
    np.testing.assert_allclose(hi, 1.1 * mean, rtol=1e-6)
