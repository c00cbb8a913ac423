"""Port parity: the generic performance model, its DE fit, the tables and
the black-box baselines against ``repro.core``.

The port runs on the CPU. The expression and its cost are held to the
reference at rtol 1e-5 (both fp32: exp/log and the sums over features and
rows round differently in XLA and in PyTorch). DE draws differ between
``jax.random`` and ``torch.Generator``, so a fit is held to the reference's
by the cost it reaches (within 10 %), not by x. On these fits DE's final
cost is multimodal over seeds (seeds of either package land in the same
few basins), so the best cost is taken over enough seeds (10-12) for both
packages to reach the lowest basin. The tables and baselines are numpy on
both sides: equal strings and equal predictions.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import interpret as JI
from repro.core.fit import fit_model as jax_fit_model
from repro.core.fit import fit_sweep_rows as jax_fit_sweep_rows
from repro.core.generic_model import FeatureSpec as JaxSpec
from repro.core.generic_model import PerfModel as JaxModel
from repro.core.generic_model import cost_fn as jax_cost_fn
from repro.core.generic_model import encode_dataset as jax_encode
from repro.core.generic_model import predict_times as jax_predict
from repro.perf.features import get_spec as jax_get_spec
from repro_torch.core import baselines as TB
from repro_torch.core import interpret as TI
from repro_torch.core.de import de_multi_seed, differential_evolution_torch
from repro_torch.core.fit import fit_model, fit_sweep_rows, lambda_sweep
from repro_torch.core.generic_model import (FeatureSpec, PerfModel, cost_fn,
                                            encode_dataset, predict_times)
from repro_torch.perf.features import LENET_SPEC, get_spec
from repro_torch.perf.sweep import sample_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "benchmarks", "artifacts")
RTOL = 1e-5
COST_RTOL = 0.10     # port's best DE cost vs the reference's

# The reference's own synthetic law (tests/test_perfmodel.py).
TOY = dict(numeric=("k", "f"), categorical=(("act", ("a", "b")),),
           extrinsic=("gpus", "batch"))


def _true_t(s):
    a_act = {"a": 5.0, "b": 8.0}[s["act"]]
    tI = 3 * s["k"] ** 2 + 0.5 * s["f"] ** 1.5 + a_act
    return tI * s["gpus"] ** -1.0 * s["batch"] ** -0.9 + 2.0


def _sample(n, seed, noise=0.01):
    rng = np.random.default_rng(seed)
    samples = [dict(k=int(rng.choice([2, 3, 4, 5])),
                    f=int(rng.choice([4, 8, 16, 32, 64])),
                    act=str(rng.choice(["a", "b"])),
                    gpus=int(rng.choice([1, 2, 4])),
                    batch=int(rng.choice([8, 16, 32, 64, 128])))
               for _ in range(n)]
    times = [_true_t(s) * (1 + noise * rng.normal()) for s in samples]
    return samples, times


def _arch_rows(family):
    with open(os.path.join(ART, f"arch_sweep_{family}.json")) as f:
        return json.load(f)


def _dataset(name):
    """(port spec, reference spec, samples, times) for one feature family."""
    if name == "toy":
        samples, times = _sample(200, seed=1)
        return FeatureSpec(**TOY), JaxSpec(**TOY), samples, times
    if name == "lenet":
        rng = np.random.default_rng(0)
        cfgs = [sample_config(rng) for _ in range(120)]
        samples = [get_spec("lenet").features(c) for c in cfgs]
        times = list(np.random.default_rng(1).uniform(1.0, 300.0, len(cfgs)))
        return LENET_SPEC, jax_get_spec("lenet").spec, samples, times
    rows = [r for r in _arch_rows(name) if "error" not in r]
    return (get_spec(name).spec, jax_get_spec(name).spec,
            [r["features"] for r in rows], [r["time_ms"] for r in rows])


def _fixed_x(spec, n, seed):
    lo, hi = spec.bounds()
    rng = np.random.default_rng(seed)
    # a, C over (0, 10] and p, q over [-2, 2] keep exp() finite in fp32
    hi = np.where(lo < 0, 2.0, 10.0)
    lo = np.where(lo < 0, -2.0, 0.0)
    return (lo + (hi - lo) * rng.uniform(size=(n, spec.n_params))
            ).astype(np.float32)


DATASETS = ["toy", "lenet", "lm", "moe", "ssm"]


@pytest.mark.parametrize("name", DATASETS)
def test_encode_dataset_equal(name):
    spec, jspec, samples, times = _dataset(name)
    got = encode_dataset(spec, samples, times, device="cpu")
    want = jax_encode(jspec, samples, times)
    assert spec == FeatureSpec(jspec.numeric, jspec.categorical, jspec.extrinsic)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", DATASETS)
def test_predict_and_cost_match_reference(name):
    """predict_times unbatched and batched (a population of 7), cost_fn
    for none / l1 / l2 at fixed x, rtol 1e-5."""
    spec, jspec, samples, times = _dataset(name)
    enc = encode_dataset(spec, samples, times, device="cpu")
    jenc = jax_encode(jspec, samples, times)
    xs = _fixed_x(spec, 7, seed=2)
    batched = predict_times(spec, torch.from_numpy(xs), *enc[:3])
    np.testing.assert_allclose(
        batched.numpy(), np.asarray(jax_predict(jspec, jnp.asarray(xs), *jenc[:3])),
        rtol=RTOL)
    for x in xs[:2]:
        np.testing.assert_allclose(
            predict_times(spec, torch.from_numpy(x), *enc[:3]).numpy(),
            np.asarray(jax_predict(jspec, jnp.asarray(x), *jenc[:3])), rtol=RTOL)
    for reg, lam in (("none", 0.0), ("l1", 1e-3), ("l2", 1e-3)):
        got = cost_fn(spec, torch.from_numpy(xs), *enc, reg=reg, lam=lam)
        want = jax_cost_fn(jspec, jnp.asarray(xs), *jenc, reg=reg, lam=lam)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   err_msg=reg)
        one = cost_fn(spec, torch.from_numpy(xs[0]), *enc, reg=reg, lam=lam)
        assert one.shape == () and abs(float(one) - float(got[0])) <= \
            RTOL * abs(float(got[0]))


def test_encode_rejects_non_positive_numerics():
    spec = FeatureSpec(**TOY)
    bad = [dict(k=0, f=4, act="a", gpus=1, batch=8)]
    with pytest.raises(ValueError, match="positive"):
        encode_dataset(spec, bad, device="cpu")


# ---------------------------------------------------------------------------
# DE (mirrors tests/test_perfmodel.py's DE tests)
# ---------------------------------------------------------------------------

def test_de_converges_on_sphere():
    c = torch.tensor([1.5, -2.0, 0.5, 3.0])

    def cost(x):
        return ((x - c) ** 2).sum(-1)

    res = differential_evolution_torch(
        cost, (np.full(4, -5.0), np.full(4, 5.0)), seed=0, maxiter=150,
        device="cpu")
    assert float(res.fun) < 1e-3, float(res.fun)
    np.testing.assert_allclose(res.x.numpy(), c.numpy(), atol=0.05)
    assert res.population.shape == (60, 4) and res.energies.shape == (60,)


def test_de_respects_bounds_and_is_deterministic():
    c = torch.tensor([4.9, -4.9])         # optimum at the box corner

    def cost(x):
        return ((x - c) ** 2).sum(-1)

    bounds = (np.full(2, -2.0), np.full(2, 2.0))
    r1 = differential_evolution_torch(cost, bounds, seed=3, maxiter=80,
                                      device="cpu")
    r2 = differential_evolution_torch(cost, bounds, seed=3, maxiter=80,
                                      device="cpu")
    assert (r1.population >= -2.0 - 1e-6).all()
    assert (r1.population <= 2.0 + 1e-6).all()
    np.testing.assert_allclose(r1.x.numpy(), [2.0, -2.0], atol=1e-2)
    assert torch.equal(r1.x, r2.x)
    assert torch.equal(r1.population, r2.population)
    rs = de_multi_seed(cost, bounds, seeds=[3], maxiter=80, device="cpu")
    assert torch.equal(rs[0].x, r1.x)
    r3, r4 = (differential_evolution_torch(cost, bounds, seed=s, maxiter=0,
                                           polish_steps=0, device="cpu")
              for s in (3, 4))
    assert not torch.equal(r3.population, r4.population)


def test_de_polish_never_worsens():
    """The Adam polish is kept only when it lowers the cost."""
    c = torch.tensor([0.3, -0.7, 1.1])

    def cost(x):
        return (x - c).abs().sum(-1)

    bounds = (np.full(3, -2.0), np.full(3, 2.0))
    raw = differential_evolution_torch(cost, bounds, seed=1, maxiter=20,
                                       polish_steps=0, device="cpu")
    pol = differential_evolution_torch(cost, bounds, seed=1, maxiter=20,
                                       polish_steps=200, device="cpu")
    assert float(pol.fun) <= float(raw.fun)
    assert float(pol.fun) == pytest.approx(float(cost(pol.x)), rel=1e-6)


# ---------------------------------------------------------------------------
# fit_model / fit_sweep_rows vs the reference
# ---------------------------------------------------------------------------

def test_fit_model_matches_reference_cost():
    spec, jspec = FeatureSpec(**TOY), JaxSpec(**TOY)
    samples, times = _sample(300, seed=0)
    test_s, test_t = _sample(100, seed=5)
    kw = dict(test_samples=test_s, test_times=test_t, seeds=tuple(range(10)),
              maxiter=200)
    got = fit_model(spec, samples, times, device="cpu", **kw)
    want = jax_fit_model(jspec, samples, times, **kw)
    assert got.backend == "torch" and got.model.device == "cpu"
    assert abs(min(got.seed_costs) - min(want.seed_costs)) <= \
        COST_RTOL * min(want.seed_costs), (got.seed_costs, want.seed_costs)
    assert got.train_metrics["mape"] < 0.35 and want.train_metrics["mape"] < 0.35
    assert got.model.x.shape == (spec.n_params,)
    assert got.model.x_seeds.shape == (10, spec.n_params)
    # the fitted model's numpy API: predictions for raw samples
    np.testing.assert_allclose(got.model.predict(test_s[:5]),
                               jax_predict(jspec, jnp.asarray(got.model.x),
                                           *jax_encode(jspec, test_s[:5])),
                               rtol=RTOL)


def test_fit_sweep_rows_matches_reference_on_arch_rows():
    rows = _arch_rows("lm")
    kw = dict(seeds=tuple(range(12)), maxiter=250)
    got, n_fit, n_test = fit_sweep_rows(get_spec("lm").spec, rows, "jit",
                                        "measured", device="cpu", **kw)
    want, m_fit, m_test = jax_fit_sweep_rows(jax_get_spec("lm").spec, rows,
                                             "jit", "measured", **kw)
    assert (n_fit, n_test) == (m_fit, m_test) == (28, 20)
    assert abs(min(got.seed_costs) - min(want.seed_costs)) <= \
        COST_RTOL * min(want.seed_costs), (got.seed_costs, want.seed_costs)


def test_scipy_backend_and_lambda_sweep_run():
    spec = FeatureSpec(numeric=("k",), categorical=(), extrinsic=("g",))
    samples = [dict(k=1 + i % 3, g=1 + i % 2) for i in range(12)]
    times = [2.0 * s["k"] / s["g"] + 1.0 for s in samples]
    r = fit_model(spec, samples, times, seeds=(0,), backend="scipy",
                  maxiter=30, device="cpu")
    assert r.backend == "scipy" and r.train_metrics["mape"] < 0.2
    with pytest.raises(ValueError):
        fit_model(spec, samples, times, seeds=(0,), backend="jax",
                  device="cpu")
    out = lambda_sweep(spec, samples, times, samples, times, reg="l1",
                       lams=(0.0, 1e-2), seeds=(0,), maxiter=20, device="cpu")
    assert [lam for lam, _ in out] == [0.0, 1e-2]
    assert all(len(o["x"]) == spec.n_params for _, o in out)


# ---------------------------------------------------------------------------
# Tables and baselines (numpy on both sides)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeds", [None, 3])
def test_tables_print_the_same_strings(seeds):
    spec, jspec = LENET_SPEC, jax_get_spec("lenet").spec
    xs = _fixed_x(spec, seeds or 1, seed=9).astype(np.float64)
    kw = dict(x_seeds=xs if seeds else None, reg="l2", lam=1e-3)
    port, ref = PerfModel(spec, xs[0], **kw), JaxModel(jspec, xs[0], **kw)
    assert TI.format_table(port, "t") == JI.format_table(ref, "t")
    assert TI.scaling_report(port) == JI.scaling_report(ref)
    assert TI.table_rows(port) == JI.table_rows(ref)
    assert port.param_table() == ref.param_table()
    assert port.scaling_powers() == ref.scaling_powers()


def test_residual_report_equal():
    rows = _arch_rows("moe")
    assert TI.residual_report(rows) == JI.residual_report(rows)
    assert TI.measured_vs_simulated(rows) == JI.measured_vs_simulated(rows)


def test_baselines_predict_the_same():
    spec, jspec, samples, times = _dataset("lenet")
    X = TB.encode_blackbox(spec, samples[:80])
    np.testing.assert_array_equal(X, JB.encode_blackbox(jspec, samples[:80]))
    Xt = TB.encode_blackbox(spec, samples[80:])
    y = np.asarray(times[:80])
    for port, ref in ((TB.RandomForestRegressor(n_trees=8, seed=3),
                       JB.RandomForestRegressor(n_trees=8, seed=3)),
                      (TB.SVR(iters=100, seed=3), JB.SVR(iters=100, seed=3))):
        np.testing.assert_array_equal(port.fit(X, y).predict(Xt),
                                      ref.fit(X, y).predict(Xt))
