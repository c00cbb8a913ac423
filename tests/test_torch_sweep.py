"""Port parity: the LeNet-5 sweep's rows against ``repro.perf.sweep``.

Both packages sample the same configs from a seed and price the same
schedules, so every column but the measured time is held to equality
(``==``); the measured time is each package's own clock. Rows of either
package fit under either package's ``fit_model``. The port runs on the
CPU in eager mode, the reference jitted (its eager mode dispatches op by
op, ten times slower on this host).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro.core.fit import fit_model as jax_fit_model
from repro.perf import sweep as JS
from repro.perf.features import get_spec as jax_get_spec
from repro_torch.core.fit import fit_model
from repro_torch.perf import sweep as TS
from repro_torch.perf.features import LENET_SPEC, get_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "benchmarks", "artifacts")
EQUAL_COLUMNS = ("features", "param_bytes", "comm_ms", "act_bytes",
                 "calibration", "t_measured_sharded", "sharded_skip",
                 "family", "norm_unit")


@pytest.fixture(scope="module")
def sweeps():
    """A 6-trial sweep of each package from seed 4: the port's eager, the
    reference's jitted."""
    port = TS.run_sweep(6, modes=("eager",), seed=4, verbose_every=0,
                        device="cpu")
    ref = JS.run_sweep(6, modes=("jit",), seed=4, verbose_every=0)
    return port, ref


@pytest.mark.parametrize("seed", [0, 17])
def test_sample_config_same_configs(seed):
    port = np.random.default_rng(seed)
    ref = np.random.default_rng(seed)
    for _ in range(100):
        assert dataclasses.asdict(TS.sample_config(port)) == \
            dataclasses.asdict(JS.sample_config(ref))


def test_sweep_row_fields_equal():
    assert [f.name for f in dataclasses.fields(TS.SweepRow)] == \
        [f.name for f in dataclasses.fields(JS.SweepRow)]
    assert TS.MODES == JS.MODES
    assert (TS.SKIP_EAGER, TS.SKIP_POOL, TS.SKIP_NOT_REQUESTED) == \
        (JS.SKIP_EAGER, JS.SKIP_POOL, JS.SKIP_NOT_REQUESTED)
    assert (TS.REF_SAMPLES, TS.REF_TOKENS) == (JS.REF_SAMPLES, JS.REF_TOKENS)


def test_eager_sweep_rows_equal_but_for_the_clock(sweeps):
    port, ref = sweeps
    assert len(port) == len(ref) == 6
    for p, r in zip(port, ref):
        assert "error" not in p and "error" not in r
        assert list(p) == list(r)                    # same keys, same order
        for col in EQUAL_COLUMNS:
            assert p[col] == r[col], col
        assert (p["mode"], r["mode"]) == ("eager", "jit")
        assert p["measured_ms"] > 0
        assert p["time_ms"] == p["t_simulated"] == p["measured_ms"] + p["comm_ms"]


def test_lenet_act_bytes_and_comm_equal():
    rng = np.random.default_rng(3)
    for _ in range(40):
        cfg = TS.sample_config(rng)
        jcfg = JS.LeNet5Config(**dataclasses.asdict(cfg))
        assert TS.lenet_act_bytes(cfg) == JS.lenet_act_bytes(jcfg)
        assert TS.comm_seconds(cfg, 654_321) == JS.comm_seconds(jcfg, 654_321)


@pytest.mark.parametrize("family", ["lm", "moe", "ssm"])
def test_fit_target_and_split_rows_equal(family):
    with open(os.path.join(ART, f"arch_sweep_{family}.json")) as f:
        rows = json.load(f)
    for source in ("measured", "simulated", "compute"):
        ok = [r for r in rows if "error" not in r]
        assert [TS.fit_target_ms(r, source) for r in ok] == \
            [JS.fit_target_ms(r, source) for r in ok]
        assert TS.split_rows(rows, "jit", source=source) == \
            JS.split_rows(rows, "jit", source=source)
    assert TS.split_rows(rows, "jit", n_fit=10) == JS.split_rows(rows, "jit",
                                                                  n_fit=10)


def test_rows_fit_under_either_package(sweeps):
    port, ref = sweeps
    kw = dict(seeds=(0,), maxiter=20)
    mixed = port + [dict(r, mode="eager") for r in ref]
    f_s, t_s, _, _ = TS.split_rows(mixed, "eager")
    r_ref = jax_fit_model(jax_get_spec("lenet").spec, f_s, t_s, **kw)
    f_s, t_s, _, _ = JS.split_rows(mixed[::-1], "eager")
    r_port = fit_model(LENET_SPEC, f_s, t_s, device="cpu", **kw)
    for r in (r_ref, r_port):
        assert np.isfinite(r.train_metrics["mae"])
        assert r.model.x.shape == (LENET_SPEC.n_params,)
    assert get_spec("lenet").spec == LENET_SPEC


def test_sharded_probe_measures_on_a_pool():
    """measure_trial(sharded=True) on a CPU pool of 2 measures the sharded
    iteration of a compiled trial at n = 2; an eager trial records
    SKIP_EAGER and a trial above the pool SKIP_POOL."""
    from repro_torch.dist.pool import Pool
    cfg = dataclasses.replace(TS.sample_config(np.random.default_rng(0)),
                              n_devices=2, batch_size=16)
    with Pool(world=2, device="cpu") as pool:
        row = TS.measure_trial(cfg, "jit", sharded=True, pool=pool, device="cpu")
        big = TS.measure_trial(dataclasses.replace(cfg, n_devices=4), "eager",
                               sharded=True, pool=pool, device="cpu")
    assert row.t_measured_sharded > 0 and row.sharded_skip is None
    assert row.t_simulated == row.measured_ms + row.comm_ms
    assert (big.t_measured_sharded, big.sharded_skip) == (None, TS.SKIP_EAGER)
    assert TS.measure_sharded_trial(dataclasses.replace(cfg, n_devices=4), "jit",
                                    pool=pool) == (None, TS.SKIP_POOL)


def test_unknown_mode_raises():
    cfg = TS.sample_config(np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown mode"):
        TS.make_iteration(cfg, "graphs")


def test_measure_trial_records_warmup():
    cfg = dataclasses.replace(TS.sample_config(np.random.default_rng(1)),
                              batch_size=8)
    warm = []
    row = TS.measure_trial(cfg, "eager", seed=2, device="cpu", warmup_s=warm)
    assert len(warm) == 1 and warm[0] > 0
    assert row.mode == "eager" and row.measured_ms > 0
    assert row.sharded_skip == TS.SKIP_NOT_REQUESTED
    assert row.param_bytes == sum(
        int(np.prod(s)) * 4 for s in
        [(cfg.n_filters, 3 if cfg.dataset == "cifar10" else 1,
          cfg.kernel_size, cfg.kernel_size),
         (2 * cfg.n_filters, cfg.n_filters, cfg.kernel_size, cfg.kernel_size),
         (120, TS.feature_dims(cfg)[2]), (84, 120), (10, 84)])
