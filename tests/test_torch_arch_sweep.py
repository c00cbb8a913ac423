"""Port parity: the arch half of the sweep (``repro_torch.perf.sweep``:
``ArchPoint``, ``sample_arch_point``, ``arch_mesh_axes``,
``measure_arch_trial``'s comm pricing), ``perf.planner.space.model_comm_sizes``
and the recorder's spans (``repro_torch.obs.trace``) against
``repro.perf.sweep``, ``repro.perf.planner.space`` and ``repro.obs.trace``,
on the CPU; and the entry point ``python -m repro_torch.launch.arch_sweep``
against the reference's calibration and fit functions on the checked-in
rows.

The same seeds draw the same points; each point's config, features, mesh
and comm sizes are equal (the sizes as integers, the comm price at rtol
1e-12); one point a family has the reference's eager loss on the
reference's weights (fp32, rtol 1e-5 as ``tests/test_torch_train.py``).
The compiled steps' parity is ``tests/test_torch_arch_compile.py``.
"""
import dataclasses
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.data import make_batch_for as jax_batch_for
from repro.models import model as JMD
from repro.models.layers import pvalues
from repro.obs.trace import Recorder as JRecorder
from repro.obs.trace import use_recorder as jax_use_recorder
from repro.perf import sweep as JS
from repro.perf.costmodel import DEFAULT_CALIBRATION as JDEFAULT
from repro.perf.planner.space import model_comm_sizes as jax_comm_sizes
from repro.perf.predict import estimate_comm as jax_estimate_comm
from repro_torch.data import make_batch_for
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.trace import Recorder, use_recorder
from repro_torch.perf import sweep as S
from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
from repro_torch.perf.planner.space import model_comm_sizes
from repro_torch.perf.predict import estimate_comm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
ART = os.path.join(BENCH, "artifacts")
FAMILIES = ("lm", "moe", "ssm")
SEEDS = (0, 3, 11)
N_POINTS = 12


def _points(family, seed, n=N_POINTS):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    return ([S.sample_arch_point(family, rng) for _ in range(n)],
            [JS.sample_arch_point(family, jrng) for _ in range(n)])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_points_configs_and_features(family, seed):
    pts, jpts = _points(family, seed)
    for p, jp in zip(pts, jpts):
        assert dataclasses.asdict(p) == dataclasses.asdict(jp)
        assert p.wire_bits == jp.wire_bits
        assert p.features() == jp.features()
        assert (dataclasses.asdict(p.model_config())
                == dataclasses.asdict(jp.model_config()))


def test_arch_grid_constants_equal():
    assert S.ARCH_N_DEVICES == JS.ARCH_N_DEVICES
    assert S.ARCH_BATCH_SIZES == JS.ARCH_BATCH_SIZES
    assert S.ARCH_COMPRESSIONS == JS.ARCH_COMPRESSIONS


@pytest.mark.parametrize("strategy", ["dp", "fsdp", "tp", "fsdp_tp"])
def test_arch_mesh_axes(strategy):
    for n in (1, 2, 4, 8):
        got = S.arch_mesh_axes(strategy, n)
        want = JS.arch_mesh_axes(strategy, n)
        assert got == want and list(got) == list(want)


@pytest.mark.parametrize("family", FAMILIES)
def test_model_comm_sizes_and_comm_ms(family):
    """Integer-equal (param_bytes, act_bytes) and the comm price at rtol
    1e-12 on sampled points, both under the default link."""
    pts, _ = _points(family, 0, n=6)
    for p in pts:
        cfg = p.model_config()
        jcfg = JS.ArchPoint(**dataclasses.asdict(p)).model_config()
        got = model_comm_sizes(cfg, p.batch_size, p.seq_len)
        want = jax_comm_sizes(jcfg, p.batch_size, p.seq_len)
        assert got == tuple(int(x) for x in want)
        ms = estimate_comm(p.strategy, p.n_devices, got[0],
                           wire_bits=p.wire_bits, act_bytes=got[1],
                           calibration=DEFAULT_CALIBRATION).seconds
        jms = jax_estimate_comm(p.strategy, p.n_devices, int(want[0]),
                                wire_bits=p.wire_bits, act_bytes=int(want[1]),
                                calibration=JDEFAULT).seconds
        np.testing.assert_allclose(ms, jms, rtol=1e-12)


def test_comm_sizes_of_a_checked_in_row():
    """The checked-in lm row with d_model 64, 2 layers, d_ff 64."""
    rows = json.load(open(os.path.join(ART, "arch_sweep_lm.json")))
    row = next(r for r in rows if "error" not in r
               and (r["features"]["d_model"], r["features"]["n_layers"],
                    r["features"]["d_ff"]) == (64, 2, 64))
    f = row["features"]
    p = S.ArchPoint(family="lm", arch_id=f["arch"], seq_len=f["seq_len"],
                    d_model=64, n_layers=2, d_ff=64)
    pb, ab = model_comm_sizes(p.model_config(), f["batch_size"], f["seq_len"])
    assert (pb, ab) == (row["param_bytes"], row["act_bytes"])
    assert pb == 148736 and (ab == 262144 or f["seq_len"] * f["batch_size"]
                             != 512)


@pytest.mark.parametrize("family", FAMILIES)
def test_eager_loss_at_a_sampled_point(family):
    """The point's config in fp32, the reference's init converted to the
    port, the reference's batch: equal losses (rtol 1e-5)."""
    p = _points(family, 0, n=1)[0][0]
    cfg = dataclasses.replace(p.model_config(), dtype="float32",
                              param_dtype="float32")
    jcfg = dataclasses.replace(JS.ArchPoint(**dataclasses.asdict(p)).model_config(),
                               dtype="float32", param_dtype="float32")
    jparams = JMD.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, pvalues(jparams)), cfg,
                             device="cpu")
    jbatch = jax_batch_for(jcfg, 4, p.seq_len, seed=0)
    batch = make_batch_for(cfg, 4, p.seq_len, seed=0)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(jbatch["tokens"]))
    jloss, _ = JMD.loss_fn(jparams, jcfg, jbatch, remat="none")
    with torch.no_grad():
        loss, _ = MD.loss_fn(params, cfg, batch, remat="none")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_arch_train_config_is_the_references():
    assert (dataclasses.asdict(S.arch_train_config("int8_ef"))
            == dataclasses.asdict(JTrainConfig(optimizer="sgd",
                                               grad_compression="int8_ef",
                                               remat_policy="none")))


def _spans(rec):
    return [(s.name, s.category, s.depth, s.attrs) for s in rec.spans]


def test_sweeps_emit_the_reference_spans():
    """One LeNet trial (jit, sharded, no pool) and one arch trial (eager, so
    the reference steps op by op and the port compiles nothing): the same
    span names, categories, nesting and attributes in both packages."""
    with use_recorder(Recorder()) as rec:
        S.run_sweep(n_trials=1, modes=("jit",), seed=2, sharded=True,
                    device="cpu", verbose_every=0)
        S.run_arch_sweep("lm", n_trials=1, mode="eager", seed=0, device="cpu",
                         verbose_every=0, n_iters=1)
    with jax_use_recorder(JRecorder()) as jrec:
        JS.run_sweep(n_trials=1, modes=("jit",), seed=2, sharded=True,
                     verbose_every=0)
        JS.run_arch_sweep("lm", n_trials=1, mode="eager", seed=0,
                          verbose_every=0, n_iters=1)
    got, want = _spans(rec), _spans(jrec)
    assert got == want
    assert [n for n, *_ in got] == ["compute_probe", "sharded_probe", "trial",
                                    "compute_probe", "trial"]


def _tree_hash(path):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_entry_point_dry_run_and_refusals(tmp_path, capsys):
    from repro_torch.launch import arch_sweep
    plan = arch_sweep.main(["--dry-run", "--quick", "--families", "lm,ssm"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == {"arch_sweep_plan": plan}
    assert plan["families"] == ["lm", "ssm"] and plan["trials"] == 8
    assert (plan["seeds"], plan["maxiter"]) == (2, 120)
    with pytest.raises(SystemExit):
        arch_sweep.main(["--device", "cpu"])                 # no --out
    assert "--out DIR is required" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        arch_sweep.main(["--device", "cpu", "--out",
                         os.path.join(BENCH, "port")])
    assert "benchmarks/" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(BENCH, "port"))


def test_entry_point_refits_the_checked_in_rows_as_the_reference(tmp_path):
    """``--rows-dir benchmarks/artifacts``: the port's per-family links,
    priced by the reference's ``link_transfer_matrix``, give the port's
    matrix (``tests/test_torch_costmodel.py``); each family's fit, measured
    and calibrated-simulated, splits the rows as the reference does, and
    its best constants have, under the reference's ``cost_fn`` and
    metrics, the port's best cost and test metrics (rtol 1e-5, as
    ``tests/test_torch_perfmodel.py``; DE draws differ between the
    packages, so at a small --maxiter their best costs are not compared);
    nothing under benchmarks/ changes."""
    import jax.numpy as jnp

    from repro.core.generic_model import (PerfModel, cost_fn, encode_dataset,
                                          metrics)
    from repro.perf import costmodel as JC
    from repro.perf.costmodel.calibrate import \
        link_transfer_matrix as jax_transfer
    from repro.perf.features import get_spec as jax_get_spec
    from repro.perf.sweep import split_rows as jax_split_rows
    from repro_torch.launch import arch_sweep
    before = _tree_hash(BENCH)
    blob = arch_sweep.main(["--rows-dir", ART, "--device", "cpu", "--out",
                            str(tmp_path), "--seeds", "2", "--maxiter", "30"])
    assert _tree_hash(BENCH) == before
    saved = json.load(open(tmp_path / "arch_sweep_fit.json"))
    assert saved["link_transfer_mae_ms"] == blob["link_transfer_mae_ms"]
    assert (tmp_path / "ARCH_SWEEP.md").read_text().startswith(
        "# Cross-architecture sweep")
    rows = {f: json.load(open(os.path.join(ART, f"arch_sweep_{f}.json")))
            for f in FAMILIES}
    ref_cals = {f: JC.Calibration.from_dict(c)
                for f, c in blob["calibrations"].items()}
    assert set(ref_cals) == set(FAMILIES)
    assert jax_transfer(rows, ref_cals) == blob["link_transfer_mae_ms"]
    for family in FAMILIES:
        spec = jax_get_spec(family).spec
        for label, fit_rows, source in (
                ("measured", rows[family], "measured"),
                ("simulated (calibrated)",
                 JC.resimulate_rows(rows[family], ref_cals[family]),
                 "simulated")):
            got = blob["fits"][f"{family}:{label}"]
            f_s, t_s, f_t, t_t = jax_split_rows(fit_rows, "jit", source=source)
            assert (got["n_fit"], got["n_test"]) == (len(f_s), len(f_t))
            x = np.asarray(got["x"], np.float32)
            cost = cost_fn(spec, jnp.asarray(x), *encode_dataset(spec, f_s, t_s),
                           reg="l2", lam=1e-3)
            np.testing.assert_allclose(float(cost), min(got["seed_costs"]),
                                       rtol=1e-5)
            want = metrics(np.asarray(t_t), PerfModel(spec, x).predict(f_t))
            for k, v in want.items():
                np.testing.assert_allclose(got["test"][k], v, rtol=1e-5,
                                           err_msg=f"{family} {label} {k}")
