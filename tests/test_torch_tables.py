"""The port's paper-tables harness (``repro_torch.launch.{common,tables,run}``)
against the reference's (``benchmarks/{common,tables,run}.py``) on the same
360 synthetic LeNet sweep rows with a known law: the reference is pointed at
them through ``benchmarks.common.SWEEP_PATH`` (its caches cleared), so it
never measures. The DE streams differ, so each fitted number is held within
a stated band; every other number of the tables is held on the same
constants (the port's tables given the reference's DE seeds), the baselines
(numpy on both sides) and the splits exactly."""
import json
import os
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import benchmarks.common as JC  # noqa: E402
import benchmarks.tables as JT  # noqa: E402
from repro_torch.launch import common as C  # noqa: E402
from repro_torch.launch import tables as T  # noqa: E402
from repro_torch.perf.features import lenet_features  # noqa: E402
from repro_torch.perf.sweep import sample_config  # noqa: E402

N_ROWS = 360
SEEDS, MAXITER = 2, 100      # both packages' fits here (the harness's: 10, 300)
RTOL, ATOL = 1e-4, 1e-6      # a table's number on the same constants (fp32 both)
MAPE_TOL = 0.10              # the port's own L2 fit's test MAPE vs the reference's
BASELINE_RTOL = 1e-6         # RF and SVR: the same numpy on the same split
DATASET_COST = {"mnist": 1.0, "fashion_mnist": 1.2, "cifar10": 2.5}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's DE fits run many small ops: one intra-op thread keeps them
    fast when the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rows():
    """Trial i in MODES[i % 3]; the fit target (iteration ms per 128
    samples) is (0.5 k + 0.02 f^1.2 + a_dataset) · n^-0.9 · b^-0.2 + 0.3 with
    2 % noise, all on measured_ms (comm 0)."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(N_ROWS):
        f = lenet_features(sample_config(rng))
        target = ((0.5 * f["kernel_size"] + 0.02 * f["n_filters"] ** 1.2
                   + DATASET_COST[f["dataset"]]) * f["n_devices"] ** -0.9
                  * f["batch_size"] ** -0.2 + 0.3) * (1 + 0.02 * rng.standard_normal())
        ms = target * f["batch_size"] / 128
        rows.append({"features": f, "mode": C.MODES[i % 3], "measured_ms": ms,
                     "comm_ms": 0.0, "time_ms": ms})
    return rows


@pytest.fixture(scope="module")
def rows_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("sweep") / "lenet_sweep.json"
    path.write_text(json.dumps(_rows()))
    return str(path)


class OnReferenceConstants(C.Sweep):
    """A ``Sweep`` whose DE returns the reference's seeds (x and cost) for
    the same (mode, reg, λ, seeds, generations): the port's tables then
    compute every number (best seed, metrics, constants, powers) from the
    reference's constants, so they must equal the reference's tables."""

    def fit_cached(self, mode, reg, lam, seeds=10, maxiter=300):
        from repro_torch.core import fit as FIT
        ref = JC.fit_cached(mode, reg, lam, seeds, maxiter)
        runs = [SimpleNamespace(x=torch.tensor(np.asarray(x), dtype=torch.float32), fun=c)
                for x, c in zip(ref.model.x_seeds, ref.seed_costs)]
        with mock.patch.object(FIT, "de_multi_seed", lambda *a, **k: runs):
            return super().fit_cached(mode, reg, lam, seeds, maxiter)


@pytest.fixture(scope="module")
def reference(rows_path):
    """The reference's ``benchmarks.common`` pointed at the rows, its caches
    cleared before and after."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JC, "SWEEP_PATH", rows_path)
    JC._split.cache_clear()
    JC.fit_cached.cache_clear()
    yield JC
    JC._split.cache_clear()
    JC.fit_cached.cache_clear()
    mp.undo()


@pytest.fixture(scope="module")
def both(rows_path, reference):
    """{table: (port's result on the reference's constants, reference's)}
    for Tables 2-6 at the same small budget."""
    sweep = OnReferenceConstants(C.load_rows(rows_path), device="cpu")
    return sweep, {
        "table2": (T.table2_fit(sweep, SEEDS, MAXITER), JT.table2_fit(SEEDS, MAXITER)),
        "table3": (T.table3_fit_l2(sweep, SEEDS, MAXITER), JT.table3_fit_l2(SEEDS, MAXITER)),
        "table4": (T.table4_reg_compare(sweep, SEEDS, MAXITER),
                   JT.table4_reg_compare(SEEDS, MAXITER)),
        "table5": (T.table5_model_compare(sweep, SEEDS, MAXITER),
                   JT.table5_model_compare(SEEDS, MAXITER)),
        "table6": (T.table6_scaling(sweep, SEEDS, MAXITER), JT.table6_scaling(SEEDS, MAXITER)),
    }


def test_sweep_holds_the_reference_split(rows_path, both):
    sweep, _ = both
    from repro.perf.sweep import split_rows
    rows = json.load(open(rows_path))
    assert sweep.modes == C.MODES == JC.MODES
    for mode in C.MODES:
        got, want = sweep.split(mode), split_rows(rows, mode)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
        assert len(got[0]) == 72 and len(got[2]) == 48


def test_fit_cached_fits_once(both):
    sweep, _ = both
    assert sweep.fit_cached("jit", "none", 0.0, SEEDS, MAXITER) is \
        sweep.fit_cached("jit", "none", 0.0, SEEDS, MAXITER)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("table", ["table2", "table3"])
def test_constant_tables_equal_on_the_same_constants(both, table):
    got, want = both[1][table]
    assert set(got) == set(want) == set(C.MODES)
    for mode in C.MODES:
        assert [n for n, _, _ in got[mode]["params"]] == \
            [n for n, _, _ in want[mode]["params"]]
        _close([v for _, m, s in got[mode]["params"] for v in (m, s)],
               [v for _, m, s in want[mode]["params"] for v in (m, s)])
        for k in ("mape", "r2", "rmse"):
            _close(got[mode]["test"][k], want[mode]["test"][k])


def test_table4_equal_on_the_same_constants(both):
    got, want = both[1]["table4"]
    assert set(got) == set(want) == {f"{r}/{m}" for r in ("l1", "l2") for m in C.MODES}
    for k in got:
        for m in ("mape", "mse", "rmse"):
            _close(got[k][m], want[k][m])


def test_table5_equal_on_the_same_constants(both):
    got, want = both[1]["table5"]
    for mode in C.MODES:
        assert set(got[mode]) == {"DE", "DE+L2", "RF", "SVR"}
        for k in ("RF", "SVR"):            # the same numpy on the same split
            assert got[mode][k] == pytest.approx(want[mode][k], rel=BASELINE_RTOL)
        for k in ("DE", "DE+L2"):
            _close(got[mode][k], want[mode][k])


def test_table6_equal_on_the_same_constants(both):
    got, want = both[1]["table6"]
    for mode in C.MODES:
        for ext in ("n_devices", "batch_size", "wire_bits"):
            _close(got[mode][ext], want[mode][ext])


def test_own_l2_fits_within_band_of_reference(rows_path, reference):
    """The port's own DE (L2, as Tables 3 and 5 fit): each mode's test MAPE
    within ``MAPE_TOL`` of the reference's own fit at the same budget."""
    sweep = C.Sweep(C.load_rows(rows_path), device="cpu")
    for mode in C.MODES:
        got = sweep.fit_cached(mode, "l2", 1e-3, SEEDS, MAXITER).test_metrics["mape"]
        want = JC.fit_cached(mode, "l2", 1e-3, SEEDS, MAXITER).test_metrics["mape"]
        assert abs(got - want) <= MAPE_TOL, (mode, got, want)


def test_figures_on_two_lambdas(rows_path, reference, monkeypatch):
    """Figures 7 and 8 on the reference's λ grid cut to two values here
    (each λ is a fit): the same keys, equal on the same constants."""
    monkeypatch.setattr(T, "LAMBDAS", (1e-3, 1.0))
    sweep = OnReferenceConstants(C.load_rows(rows_path), device="cpu")
    f7, f8 = (T.fig7_lambda_sweep(sweep, "jit", SEEDS, MAXITER),
              T.fig8_coeff_paths(sweep, "jit", SEEDS, MAXITER))
    from repro_torch.perf.features import LENET_SPEC
    assert set(f7) == {"l1", "l2"} and [r["lam"] for r in f7["l2"]] == [1e-3, 1.0]
    assert list(f8[1e-3]) == LENET_SPEC.param_names()
    for reg in ("l1", "l2"):
        for r in f7[reg]:
            want = JC.fit_cached("jit", reg, r["lam"], SEEDS, MAXITER).test_metrics
            _close([r["r2"], r["mape"]], [want["r2"], want["mape"]])
    for lam, x in f8.items():
        _close(list(x.values()),
               np.asarray(JC.fit_cached("jit", "l2", lam, SEEDS, MAXITER).model.x))


def test_run_cli_table2_quick(rows_path, tmp_path, capsys):
    from repro_torch.launch import run
    out = tmp_path / "results.json"
    res = run.main(["--only", "table2", "--quick", "--device", "cpu", "--rows", rows_path,
                    "--out", str(out)])
    assert set(res) == {"table2"} and set(res["table2"]) == set(C.MODES)
    assert np.isfinite(json.load(open(out))["table2"]["eager"]["test"]["mape"])
    text = capsys.readouterr().out
    assert "table2_done" in text and text.count("table2,mode=") == 3


def test_run_cli_fails_on_a_failed_job(tmp_path):
    from repro_torch.launch import run
    with pytest.raises(SystemExit, match="jobs failed: table2"):
        run.main(["--only", "table2", "--device", "cpu", "--rows",
                  str(tmp_path / "missing.json")])


def test_run_rejects_unknown_jobs():
    from repro_torch.launch import run
    with pytest.raises(SystemExit):
        run.main(["--only", "table9", "--device", "cpu"])
