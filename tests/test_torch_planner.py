"""Port parity: the scenario planner (``repro_torch.perf.planner``) and
``train.step.overlap_transient_bytes`` against ``repro.perf.planner`` and
``repro.train.step`` on the CPU, with the checked-in ``planner_model.json``,
``comm_calibration.json`` and arch-sweep rows, and inputs made from seeds.

Tolerances:
- memory bytes, feasibility, skip reasons, enumeration order, decisions,
  candidate tables, comm prices and every ranking: equal;
- predicted times: within ``PRED_RTOL`` relative. Both packages evaluate the
  fitted compute term in float32 (the reference with x64 off, the port's
  ``PerfModel`` on float32 tensors) through different exp/log and
  summation orders, which differ in the last bits: 1.1e-7 relative at
  most over the LeNet plan, so the bound is four float32 ulps (2^-21);
- a small-budget refit: the held-out MAPE and the band within
  ``FIT_MAPE_ATOL`` of the reference's on the same rows (the DE draws
  differ, so the constants are not compared).
The search and report functions also take the same ``Prediction`` objects
in both packages (they read attributes only) and must then agree exactly.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.lenet5 import LeNet5Config as JLeNet
from repro.models import model as JMD
from repro.perf import planner as JP
from repro.perf.costmodel import DEFAULT_CALIBRATION as JDEFAULT
from repro.perf.planner import space as JSP
from repro.perf.planner.search import probe_slate as jprobe_slate
from repro.train.step import overlap_transient_bytes as jax_transient
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.configs.lenet5 import LeNet5Config
from repro_torch.models import model as MD
from repro_torch.perf import planner as P
from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
from repro_torch.perf.planner import space as SP
from repro_torch.perf.planner.search import probe_slate
from repro_torch.perf.sweep import arch_mesh_axes
from repro_torch.train.step import overlap_transient_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "benchmarks", "artifacts")
STRATEGIES = ("dp", "fsdp", "fsdp_tp", "tp")
DEVICES = (1, 2, 4, 8)
PRED_RTOL = 2.0 ** -21
FIT_MAPE_ATOL = 0.05
PRED_FIELDS = ("compute_ms", "comm_ms", "time_ms", "lo_ms", "hi_ms",
               "step_ms", "throughput_sps", "efficiency_sps_per_device",
               "device_seconds")


def _configs(arch, size):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if size == "reduced":
        return jreduced(jcfg), reduced(cfg)
    return jcfg, cfg


def _meshes(strategy, n):
    """The planner's mesh for (strategy, n) and the train driver's
    (data, model) factorizations of n."""
    out = [arch_mesh_axes(strategy, n)]
    for d in (1, 2, 4, 8):
        if n % d == 0:
            out.append({"data": d, "model": n // d})
    return out


# ---------------------------------------------------------------------------
# Memory: equal integers over the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_memory_terms_equal_integers(arch, size):
    """tree_shard_bytes over 4 strategies × every mesh of 1/2/4/8 ranks (the
    planner's and the train driver's (data, model) factorizations); the
    overlap transient's pair (eager, chunk) on the planner's meshes at
    reduced size; model_memory, with its transient, at 2 and 8 ranks (full
    width through ``param_shapes``): the same integers in both packages,
    the transient never None."""
    jcfg, cfg = _configs(arch, size)
    jskel = jax.eval_shape(lambda: JMD.init_model(jax.random.PRNGKey(0), jcfg))
    skel = MD.param_shapes(cfg)
    jt = JTrainConfig(optimizer="adamw", grad_compression="none",
                      remat_policy="none")
    pt = TrainConfig(optimizer="adamw", grad_compression="none",
                     remat_policy="none")
    for strategy in STRATEGIES:
        for n in DEVICES:
            for mesh in _meshes(strategy, n):
                assert SP.tree_shard_bytes(skel, mesh, strategy) == \
                    JSP.tree_shard_bytes(jskel, mesh, strategy), (strategy, mesh)
            mesh = arch_mesh_axes(strategy, n)
            pair = None
            if size == "reduced":
                pair = overlap_transient_bytes(cfg, pt, mesh, strategy)
                assert pair == jax_transient(jcfg, jt, mesh, strategy), \
                    (strategy, mesh)
            if n not in (2, 8):
                continue
            mem = SP.model_memory(cfg, strategy, n, batch_size=8, seq_len=64,
                                  optimizer="adamw", skeleton=skel)
            jmem = JSP.model_memory(jcfg, strategy, n, batch_size=8,
                                    seq_len=64, optimizer="adamw",
                                    skeleton=jskel)
            assert mem.to_dict() == jmem.to_dict(), (strategy, n)
            assert mem.gather_transient_bytes is not None
            assert mem.gather_transient_bytes == jmem.gather_transient_bytes
            if pair is not None:
                assert mem.gather_transient_bytes == sum(pair)


# ---------------------------------------------------------------------------
# Enumeration
# ---------------------------------------------------------------------------

def _space_view(pairs):
    return [(p.key(), dict(p.mesh_axes), f.ok, f.reasons, f.memory.to_dict(),
             f.mem_headroom_bytes) for p, f in pairs]


@pytest.mark.parametrize("pool,budget,base,grid,skips", [
    (8, SP.DEFAULT_MEM_BUDGET_BYTES, dict(), dict(), set()),
    (2, 8 << 20, dict(n_filters=32, optimizer="adam", dataset="cifar10"),
     dict(), {SP.SKIP_POOL, SP.SKIP_MEMORY}),
    (4, 1 << 20, dict(n_filters=8, kernel_size=3, padding="same", stride=2,
                      pool_size=3),
     dict(n_devices=(1, 3, 4, 8), batches=(6, 12, 32),
          strategies=("tp", "dp", "fsdp_tp")), {SP.SKIP_POOL, SP.SKIP_BATCH}),
])
def test_lenet_space_equal(pool, budget, base, grid, skips):
    """Every point, in order, with its mesh, feasibility, skip reasons and
    memory terms; a small pool, budget or batch skips points."""
    got = SP.enumerate_lenet_space(LeNet5Config(**base), pool=pool,
                                   mem_budget_bytes=budget, **grid)
    want = JSP.enumerate_lenet_space(JLeNet(**base), pool=pool,
                                     mem_budget_bytes=budget, **grid)
    assert got[0] and _space_view(got[0]) == _space_view(want[0])
    assert _space_view(got[1]) == _space_view(want[1])
    assert {r for _, f in got[1] for r in f.reasons} == skips


@pytest.mark.parametrize("arch", ["smollm-360m", "llama4-scout-17b-a16e",
                                  "mamba2-370m", "zamba2-1.2b"])
def test_arch_space_equal(arch):
    """The registry archs' grid (reduced): points, meshes, reasons and
    memory in the reference's order, under a budget that skips some."""
    jcfg, cfg = _configs(arch, "reduced")
    kw = dict(pool=4, seq_len=64, optimizer="adamw", mem_budget_bytes=1 << 21)
    got = SP.enumerate_space(cfg, **kw)
    want = JSP.enumerate_space(jcfg, **kw)
    assert _space_view(got[0]) == _space_view(want[0])
    assert _space_view(got[1]) == _space_view(want[1])
    assert got[1]
    assert [p.key() for p, _ in got[0] + got[1]] == \
        [p.key() for p, _ in want[0] + want[1]]


def test_estimate_memory_for_dispatches_alike():
    jcfg, cfg = _configs("smollm-360m", "reduced")
    for strategy in STRATEGIES:
        a = SP.estimate_memory_for(LeNet5Config(), strategy, 4, batch_size=32)
        b = JSP.estimate_memory_for(JLeNet(), strategy, 4, batch_size=32)
        assert a.to_dict() == b.to_dict()
        a = SP.estimate_memory_for(cfg, strategy, 4, batch_size=16,
                                   seq_len=32, optimizer="adamw")
        b = JSP.estimate_memory_for(jcfg, strategy, 4, batch_size=16,
                                    seq_len=32, optimizer="adamw")
        assert a.to_dict() == b.to_dict()


# ---------------------------------------------------------------------------
# Predictions on the checked-in model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lenet_plan():
    """(port preds, reference preds, port model, reference model, n_space)
    of the reference's default plan: LeNet-5 at n_filters 16, kernel 5,
    sgd, mnist, over a pool of 8."""
    model = P.PlannerModel.load(device="cpu")
    jmodel = JP.PlannerModel.load()
    feas, skip = SP.enumerate_lenet_space(LeNet5Config(), pool=8)
    jfeas, jskip = JSP.enumerate_lenet_space(JLeNet(), pool=8)
    return (P.predict_points(model, feas), JP.predict_points(jmodel, jfeas),
            model, jmodel, len(feas) + len(skip))


def _close(got, want):
    for f in PRED_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert abs(a - b) <= PRED_RTOL * abs(b), (f, a, b)
    assert got.point.key() == want.point.key()
    assert got.dominant_term == want.dominant_term
    assert got.mem_headroom_bytes == want.mem_headroom_bytes
    assert got.comm.to_dict() == {**want.comm.to_dict(),
                                  "exposed_ms": got.comm.to_dict()["exposed_ms"]}


def test_planner_model_loads_alike(lenet_plan):
    _, _, model, jmodel, _ = lenet_plan
    assert model.to_dict() == jmodel.to_dict()
    assert model.calibration_note() == jmodel.calibration_note()
    assert model.compute.device == "cpu"


def test_predict_points_lenet(lenet_plan):
    preds, jpreds, *_ = lenet_plan
    assert len(preds) == len(jpreds) == 240
    for got, want in zip(preds, jpreds):
        _close(got, want)


def test_plan_keys_and_text_equal(lenet_plan):
    """The reference's dry-run plan, composed of the same functions: the
    frontier, the top-10 slate (keys and order) and the printed text."""
    preds, jpreds, model, jmodel, n_space = lenet_plan
    front, jfront = P.pareto_frontier(preds), JP.pareto_frontier(jpreds)
    assert [p.point.key() for p in front] == [p.point.key() for p in jfront]
    picks = P.validation_slate(preds, 10)
    jpicks = JP.validation_slate(jpreds, 10)
    assert [p.point.key() for p in picks] == [p.point.key() for p in jpicks]
    text = P.render_plan(picks, front, model, objective="time",
                         n_space=n_space, n_feasible=len(preds))
    jtext = JP.render_plan(jpicks, jfront, jmodel, objective="time",
                           n_space=n_space, n_feasible=len(jpreds))
    assert text == jtext


@pytest.fixture(scope="module")
def lm_fits():
    """Planner models of the lm family fitted by each package at a small
    budget on the checked-in lm rows: (port's, reference's)."""
    rows = json.load(open(os.path.join(ART, "arch_sweep_lm.json")))
    kw = dict(seeds=(0, 1), maxiter=60, family="lm")
    return (P.fit_planner_model(rows, device="cpu", **kw),
            JP.fit_planner_model(rows, **kw))


def test_predict_points_arch(lm_fits):
    """ArchLaunchPoints (their seq feature surface, the per-token work
    unit) on one lm model, the reference's fit, in both packages."""
    jmodel = lm_fits[1]
    model = P.PlannerModel.from_dict(jmodel.to_dict(), device="cpu")
    jcfg, cfg = _configs("smollm-360m", "reduced")
    feas, _ = SP.enumerate_space(cfg, pool=8, seq_len=64, optimizer="adamw")
    jfeas, _ = JSP.enumerate_space(jcfg, pool=8, seq_len=64, optimizer="adamw")
    preds, jpreds = P.predict_points(model, feas), JP.predict_points(jmodel, jfeas)
    assert len(preds) == len(jpreds) > 0
    for got, want in zip(preds, jpreds):
        _close(got, want)


# ---------------------------------------------------------------------------
# Search, elastic ranking and report on the same predictions
# ---------------------------------------------------------------------------

def _keys(preds):
    return [p.point.key() for p in preds]


@pytest.mark.parametrize("which", ["port", "reference"])
def test_search_functions_equal(lenet_plan, which):
    """Fed the same Prediction objects (each package's in turn), the two
    packages' search, elastic and ranking functions agree exactly."""
    preds = lenet_plan[0] if which == "port" else lenet_plan[1]
    assert _keys(P.pareto_frontier(preds)) == _keys(JP.pareto_frontier(preds))
    for objective in P.OBJECTIVES:
        assert _keys(P.rank(preds, objective)) == _keys(JP.rank(preds, objective))
        assert [P.objective_value(p, objective) for p in preds] == \
            [JP.objective_value(p, objective) for p in preds]
    kw = [dict(), dict(diverse_by=("strategy", "n_devices")),
          dict(objective="throughput", diverse_by=("compression",))]
    cons = [None, P.Constraints(max_devices=4, min_batch=32),
            P.Constraints(strategies=("fsdp", "tp"), compressions=("int8",))]
    jcons = [None, JP.Constraints(max_devices=4, min_batch=32),
             JP.Constraints(strategies=("fsdp", "tp"), compressions=("int8",))]
    for k in (1, 5, 12):
        for extra in kw:
            for c, jc in zip(cons, jcons):
                assert _keys(P.top_k(preds, k, constraints=c, **extra)) == \
                    _keys(JP.top_k(preds, k, constraints=jc, **extra))
        for c, jc in zip(cons, jcons):
            picks = P.validation_slate(preds, k, constraints=c)
            assert _keys(picks) == _keys(JP.validation_slate(preds, k,
                                                             constraints=jc))
            assert _keys(probe_slate(preds, exclude=picks)) == \
                _keys(jprobe_slate(preds, exclude=picks))
    assert cons[1].to_dict() == jcons[1].to_dict()
    assert [P.execution_key(p) for p in preds] == \
        [JP.execution_key(p) for p in preds]
    for costs, jcosts in ((P.RestartCosts(), JP.RestartCosts()),
                          (P.RestartCosts(compile_ms=10.0, replay_steps=50.0),
                           JP.RestartCosts(compile_ms=10.0, replay_steps=50.0))):
        assert costs.to_dict() == jcosts.to_dict()
        for lam in (0.0, 0.1, 3.0, 100.0):
            assert _keys(P.rank_elastic(preds, costs, lam)) == \
                _keys(JP.rank_elastic(preds, jcosts, lam))
            assert [P.expected_time_ms(p, costs, lam) for p in preds] == \
                [JP.expected_time_ms(p, jcosts, lam) for p in preds]
        lambdas = (0.0, 1.0, 10.0, 100.0, 1000.0)
        flip, jflip = (P.elastic_flip(preds, costs, lambdas),
                       JP.elastic_flip(preds, jcosts, lambdas))
        assert (flip is None) == (jflip is None)
        if flip is not None:
            assert flip["lambda"] == jflip["lambda"]
            assert flip["base"] is jflip["base"]
            assert flip["flipped"] is jflip["flipped"]
        assert P.render_elastic_table(preds, costs, lambdas) == \
            JP.render_elastic_table(preds, jcosts, lambdas)
    picks = P.validation_slate(preds, 10)
    assert P.plan_lines(picks, "time") == JP.plan_lines(picks, "time")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_metrics_equal(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(1, 100, 12)
    meas = pred * rng.uniform(0.5, 2.0, 12)
    meas[rng.integers(12)] = meas[0]            # a measured tie
    pred[3] = pred[4]                           # a predicted tie
    for n in (1, 2, 5, 12):
        assert P.kendall_tau(pred[:n], meas[:n]) == JP.kendall_tau(pred[:n],
                                                                   meas[:n])
    assert P.ranking_metrics(pred, meas) == JP.ranking_metrics(pred, meas)
    with pytest.raises(ValueError):
        P.kendall_tau(pred[:3], meas[:4])


def test_validation_report_tables_equal(lenet_plan):
    """The report's decision-quality and slate tables are the reference's;
    only its provenance text names the port's CLI and pool."""
    preds, _, model, jmodel, n_space = lenet_plan
    slate = P.validation_slate(preds, 8)
    meas = [p.time_ms * (1.0 + 0.1 * i) for i, p in enumerate(slate)]
    metrics = P.ranking_metrics([p.time_ms for p in slate], meas)
    kw = dict(objective="time", pool=8, n_space=n_space, n_feasible=240,
              n_frontier=16, protocol="p", plan_text="plan",
              roles=["pick"] * 7 + ["probe"])
    md = P.render_validation_md(slate, meas, metrics, model, **kw)
    jmd = JP.render_validation_md(slate, meas, metrics, jmodel, **kw)
    cut = "## Decision quality"
    tail = md[md.index(cut):].split("Reading the table")[0]
    assert tail == jmd[jmd.index(cut):].split("Reading the table")[0]
    assert "repro_torch.launch.plan --validate" in md


# ---------------------------------------------------------------------------
# --strategy auto and remesh_predict
# ---------------------------------------------------------------------------

CHOOSE_GRID = [
    # the issue's case: full width, every strategy over budget, dp least-bad
    ("smollm-360m", "full", 8, 512, 4, "adamw", "int8_ef", {"data": 2, "model": 2}),
    ("smollm-360m", "reduced", 8, 64, 1, "adamw", "none", None),
    ("smollm-360m", "reduced", 8, 64, 2, "sgd", "bf16", {"data": 1, "model": 2}),
    ("smollm-360m", "reduced", 7, 32, 4, "adamw", "none", {"data": 2, "model": 2}),
    ("smollm-360m", "reduced", 16, 32, 8, "adafactor", "int8", None),
    ("qwen2.5-3b", "reduced", 8, 32, 4, "adamw", "int8_ef", {"data": 2, "model": 2}),
    ("mamba2-370m", "reduced", 8, 64, 4, "adamw", "none", None),
    ("zamba2-1.2b", "reduced", 4, 32, 2, "sgd", "int8", {"data": 2, "model": 1}),
    ("llama4-scout-17b-a16e", "reduced", 8, 32, 8, "adamw", "bf16", {"data": 2, "model": 4}),
    ("deepseek-v3-671b", "reduced", 8, 32, 4, "adamw", "none", None),
    ("gemma2-2b", "reduced", 8, 64, 4, "adamw", "int8_ef", {"data": 2, "model": 2}),
    ("whisper-tiny", "reduced", 4, 32, 2, "adamw", "none", None),
    ("qwen2.5-3b", "full", 8, 512, 8, "adamw", "int8_ef", {"data": 2, "model": 4}),
]


@pytest.mark.parametrize("calibration", ["checked-in", "default"])
@pytest.mark.parametrize("case", CHOOSE_GRID, ids=lambda c: f"{c[0]}-{c[1]}-n{c[4]}")
def test_choose_strategy_equal(case, calibration):
    """The decision, its reason and comm price, the headroom and the whole
    candidate table."""
    arch, size, batch, seq, n, opt, comp, mesh = case
    jcfg, cfg = _configs(arch, size)
    kw = dict(batch=batch, seq=seq, n_devices=n, optimizer=opt,
              compression=comp, mesh_axes=mesh)
    if calibration == "default":
        got = P.choose_strategy(cfg, calibration=DEFAULT_CALIBRATION, **kw)
        want = JP.choose_strategy(jcfg, calibration=JDEFAULT, **kw)
        assert not got.calibrated and "note" in got.to_dict()
    else:
        got, want = P.choose_strategy(cfg, **kw), JP.choose_strategy(jcfg, **kw)
    assert got.to_dict() == want.to_dict()
    if (arch, size, n) == ("smollm-360m", "full", 4):
        assert got.strategy == "dp"
        assert got.reason.startswith("no strategy fully feasible; least-bad")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_remesh_predict_equal(strategy):
    jcfg, cfg = _configs("smollm-360m", "reduced")
    for kw in (dict(batch=8, seq=64),
               dict(batch=12, seq=32, optimizer="sgd", compression="int8",
                    compute_ref=(0.25, 2)),
               dict(batch=8, seq=64, mem_budget_bytes=1 << 21,
                    calibration="default")):
        if kw.get("calibration") == "default":
            got = P.remesh_predict(cfg, strategy, **{**kw,
                                   "calibration": DEFAULT_CALIBRATION})
            want = JP.remesh_predict(jcfg, strategy, **{**kw,
                                     "calibration": JDEFAULT})
        else:
            got = P.remesh_predict(cfg, strategy, **kw)
            want = JP.remesh_predict(jcfg, strategy, **kw)
        grid = [(d, m) for d in (1, 2, 3, 4, 8) for m in (1, 2, 4)]
        assert [got(d, m) for d, m in grid] == [want(d, m) for d, m in grid]


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------

def test_fit_planner_model_close(lm_fits):
    """A small-budget fit on the checked-in lm rows in both packages: the
    same rows and split, the held-out MAPE and the predictor's band within
    FIT_MAPE_ATOL, an oversubscription width from the same grid."""
    got, want = lm_fits
    for k in ("n_fit", "n_test"):
        assert got.meta[k] == want.meta[k]
    assert got.meta["decomposition"]["n_rows"] == \
        want.meta["decomposition"]["n_rows"] == 37
    assert abs(got.compute_mape - want.compute_mape) <= FIT_MAPE_ATOL, \
        (got.compute_mape, want.compute_mape)
    assert abs(got.band_mape - want.band_mape) <= FIT_MAPE_ATOL, \
        (got.band_mape, want.band_mape)
    assert got.oversub_k in P.predict.OVERSUB_GRID
    assert got.spec_tag == want.spec_tag
    assert P.PlannerModel.from_dict(got.to_dict(), device="cpu").to_dict() == \
        got.to_dict()


def test_uncalibrated_model_is_marked(tmp_path, monkeypatch):
    """A model without its calibration and an unreachable
    ``$REPRO_CALIBRATION`` plans under the defaults, marked so, in both."""
    blob = json.load(open(P.default_model_path()))
    blob["calibration"] = None
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "missing.json"))
    with pytest.warns(UserWarning):
        model = P.PlannerModel.from_dict(blob, device="cpu")
    with pytest.warns(UserWarning):
        jmodel = JP.PlannerModel.from_dict(blob)
    assert not model.calibrated and not jmodel.calibrated
    assert model.calibration_note() == jmodel.calibration_note()
    assert P.UNCALIBRATED_NOTE == JP.UNCALIBRATED_NOTE


def test_planner_exports_the_reference_names():
    assert sorted(P.__all__) == sorted(JP.__all__)
    for name in P.__all__:
        assert hasattr(P, name), name
