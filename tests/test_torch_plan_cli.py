"""The planner's entry points on the CPU: ``python -m repro_torch.launch.plan``
(``--dry-run``, ``--refit``, ``--validate`` over a pool of CPU ranks),
``launch.train --strategy auto --report-comm`` and ``python -m
repro_torch.perf.costmodel.calibrate``, against the reference's functions
composed as ``benchmarks/plan.py`` and ``repro.launch.train`` compose them
(called directly: the reference's CLI forces its host pool only before JAX
starts, which a test process cannot promise), and chip_smoke's phase-22
constants against the reference's live plan. Predicted times compare within
``PRED_RTOL``, four float32 ulps (both packages evaluate the compute term in
float32, ``test_torch_planner.py``); keys, counts, decisions and comm prices
are equal.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.lenet5 import LeNet5Config as JLeNet
from repro.launch.train import _comm_estimate as jax_comm_estimate
from repro.perf import planner as JP
from repro.perf.planner.search import validation_slate as jvalidation_slate
from repro_torch.launch import plan, train
from repro_torch.perf import sweep as S
from repro_torch.perf.costmodel import DEFAULT_CALIBRATION, calibrate
from repro_torch.perf.costmodel import Calibration
from repro_torch.perf.features import get_spec
from repro_torch.perf.planner import PlannerModel, default_model_path
from repro_torch.perf.planner.space import lenet_param_skeleton

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ART = os.path.join(ROOT, "benchmarks", "artifacts")
CPU = ["--device", "cpu"]
PRED_RTOL = 2.0 ** -21      # four float32 ulps (test_torch_planner.py)


def _reference_plan(k=10, pool=8):
    """``benchmarks/plan.py``'s planner_plan blob (dry run, defaults),
    composed of the reference's functions."""
    model = JP.PlannerModel.load()
    feasible, skipped = JP.enumerate_lenet_space(
        JLeNet(n_filters=16, kernel_size=5, optimizer="sgd", dataset="mnist"),
        pool=pool)
    preds = JP.predict_points(model, feasible)
    frontier = JP.pareto_frontier(preds)
    picks = jvalidation_slate(preds, k, objective="time",
                              constraints=JP.Constraints())
    return {"pool": pool, "objective": "time", "k": k,
            "space": len(feasible) + len(skipped), "feasible": len(feasible),
            "skipped": [{"point": list(p.key()), "reasons": list(f.reasons)}
                        for p, f in skipped[:20]],
            "frontier_size": len(frontier),
            "frontier": [p.to_dict() for p in frontier[:10]],
            "top": [p.to_dict() for p in picks],
            "calibration": model.calibration.label,
            "calibrated": model.calibrated,
            "compute_mape": model.compute_mape}


def _close_blobs(got, want, path="plan"):
    """Equal structure and values; floats within PRED_RTOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _close_blobs(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close_blobs(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= PRED_RTOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _smoke_contract(blob, calibrated):
    """tools/planner_smoke.py's assertions on a dry-run plan."""
    assert blob["feasible"] > 0 and blob["frontier_size"] >= 1
    assert blob["frontier"] and len(blob["top"]) >= 8
    for p in blob["top"]:
        assert p["time_ms"] > 0 and p["compute_ms"] > 0
        assert p["band_ms"][0] <= p["time_ms"] <= p["band_ms"][1]
        assert p["memory"]["total_per_device"] > 0
    assert blob["calibrated"] == calibrated, blob["calibration"]
    assert blob["frontier"][0]["time_ms"] <= blob["top"][0]["time_ms"] + 1e-9


def _last_json(capsys, key):
    for line in reversed(capsys.readouterr().out.strip().splitlines()):
        if line.startswith("{") and key in line:
            return json.loads(line)[key]
    raise AssertionError(f"no {key} line")


# ---------------------------------------------------------------------------
# launch.plan --dry-run
# ---------------------------------------------------------------------------

def test_plan_dry_run_is_the_reference_plan(capsys):
    """planner_smoke's contract, and the planner_plan JSON equal to the
    reference's composed from the same functions (the JSON line printed
    is the blob returned)."""
    blob = plan.main(["--dry-run", "--k", "10"] + CPU)
    assert _last_json(capsys, "planner_plan") == json.loads(json.dumps(blob))
    _smoke_contract(blob, calibrated=True)
    want = _reference_plan()
    seconds = blob.pop("plan_seconds")
    assert seconds >= 0
    _close_blobs(blob, want)


def test_plan_fail_soft_without_calibration(tmp_path, monkeypatch, capsys):
    """The model's calibration stripped and ``$REPRO_CALIBRATION`` at a
    missing file: still a plan, under the defaults, marked uncalibrated."""
    blob = json.load(open(default_model_path()))
    blob["calibration"] = None
    stripped = tmp_path / "planner_model_nocal.json"
    stripped.write_text(json.dumps(blob))
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "missing.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = plan.main(["--dry-run", "--k", "10", "--model", str(stripped)]
                        + CPU)
    _smoke_contract(got, calibrated=False)
    assert got["calibration"] == "default"
    assert "uncalibrated α-β defaults in use" in capsys.readouterr().out


def test_chip_smoke_plan_constants_are_the_reference_plan():
    """chip_smoke's phase-22 gate constants are the reference's live plan."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_constants", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    want = _reference_plan()
    assert (cs.PLAN_SPACE, cs.PLAN_FEASIBLE, cs.PLAN_FRONTIER) == \
        (want["space"], want["feasible"], want["frontier_size"])
    assert cs.PLAN_TOP10 == tuple(
        (p["strategy"], p["n_devices"], p["batch_size"], p["compression"])
        for p in want["top"])


# ---------------------------------------------------------------------------
# --refit, and writes only where told
# ---------------------------------------------------------------------------

def _lenet_rows(n=40, seed=0):
    """Sweep rows of the reference's schema for seeded Table-1 configs: a
    compute time that grows with the work, and a sharded time that adds the
    oversubscribed compute and the default link's schedule with noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        cfg = S.sample_config(rng)
        shapes = lenet_param_skeleton(cfg)
        param_bytes = sum(p.numel() * p.element_size() for p in shapes.values())
        compute = (0.5 + 1e-3 * cfg.n_filters * cfg.batch_size
                   / cfg.n_devices) * rng.uniform(0.9, 1.1)
        comm = S.comm_seconds(cfg, param_bytes, DEFAULT_CALIBRATION) * 1e3
        sharded = (compute * max(1.0, cfg.n_devices / 2.0)
                   + comm * rng.uniform(0.8, 1.2))
        rows.append({"features": get_spec("lenet").features(cfg), "mode": "jit",
                     "measured_ms": compute, "comm_ms": comm,
                     "time_ms": compute + comm, "param_bytes": param_bytes,
                     "t_simulated": compute + comm,
                     "t_measured_sharded": sharded, "sharded_skip": None,
                     "calibration": "default",
                     "act_bytes": S.lenet_act_bytes(cfg), "family": "lenet",
                     "norm_unit": "sample"})
    return rows


@pytest.fixture(scope="module")
def rows_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("rows") / "rows.json"
    path.write_text(json.dumps(_lenet_rows()))
    return str(path)


def test_plan_refit_writes_only_the_model_out(rows_file, tmp_path, capsys):
    """--refit fits from --rows on the device and writes --model-out, which
    then plans; nothing else is written."""
    out = tmp_path / "model.json"
    before = {f: os.path.getmtime(os.path.join(ART, f)) for f in os.listdir(ART)}
    blob = plan.main(["--refit", "--rows", rows_file, "--model-out", str(out),
                      "--seeds", "1", "--maxiter", "20", "--k", "8"] + CPU)
    assert out.exists() and sorted(os.listdir(tmp_path)) == ["model.json"]
    model = PlannerModel.load(str(out), device="cpu")
    assert model.calibration.label.startswith("planner:oversub-k=")
    assert model.meta["decomposition"]["n_rows"] == \
        sum(r["features"]["n_devices"] > 1 for r in _lenet_rows())
    assert blob["calibration"] == model.calibration.label
    again = plan.main(["--dry-run", "--model", str(out), "--k", "8"] + CPU)
    assert [p["time_ms"] for p in again["top"]] == \
        [p["time_ms"] for p in blob["top"]]
    assert before == {f: os.path.getmtime(os.path.join(ART, f))
                      for f in os.listdir(ART)}
    capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["--validate"],
    ["--refit", "--rows", "ROWS"],
    ["--model", "MISSING"],
])
def test_plan_refuses_a_write_without_a_path(argv, rows_file, tmp_path, capsys):
    argv = [a.replace("ROWS", rows_file)
            .replace("MISSING", str(tmp_path / "none.json")) for a in argv]
    with pytest.raises(SystemExit) as e:
        plan.main(argv + CPU)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--out" in err or "--model-out" in err
    assert not os.listdir(tmp_path)


def test_plan_refit_dry_run_writes_nothing(rows_file, tmp_path):
    blob = plan.main(["--dry-run", "--refit", "--rows", rows_file,
                      "--seeds", "1", "--maxiter", "10"] + CPU)
    assert blob["calibration"].startswith("planner:oversub-k=")
    assert not os.listdir(tmp_path)


def test_plan_refit_without_rows_is_actionable(tmp_path):
    with pytest.raises(SystemExit, match="fit_perfmodel --sharded"):
        plan.main(["--refit", "--model-out", str(tmp_path / "m.json")] + CPU)


# ---------------------------------------------------------------------------
# --validate over a pool of CPU ranks
# ---------------------------------------------------------------------------

def test_plan_validate_on_a_cpu_pool(tmp_path, capsys):
    """The interleaved protocol: each program built once on its ranks (the
    rank-side cache), then rounds × iterations timed, the report and JSON
    written into --out and nowhere else."""
    blob = plan.main(["--validate", "--pool", "2", "--devices", "1,2",
                      "--strategies", "dp", "--batches", "8",
                      "--compressions", "int8", "--k", "2", "--iters", "1",
                      "--rounds", "2", "--out", str(tmp_path)] + CPU)
    out = capsys.readouterr().out
    assert out.count("  built ") == 2
    assert out.count("round ") == 2
    assert sorted(os.listdir(tmp_path)) == ["PLANNER.md",
                                            "planner_validation.json"]
    saved = json.load(open(tmp_path / "planner_validation.json"))
    assert saved["metrics"] == blob["metrics"]
    assert blob["metrics"]["n"] == 2 and blob["roles"] == ["pick", "pick"]
    assert [s["n_devices"] for s in blob["slate"]] == [2, 1]
    assert all(np.isfinite(m) and m > 0 for m in blob["measured_ms"])
    assert (blob["iters"], blob["rounds"], blob["device"]) == (1, 2, "cpu")
    assert not plan._PROGRAMS          # released on rank 0
    md = open(tmp_path / "PLANNER.md").read()
    assert "top-1 in measured top-3" in md and "world of 2 ranks" in md


# ---------------------------------------------------------------------------
# launch.train --strategy auto --report-comm
# ---------------------------------------------------------------------------

def _reference_auto(arch, batch, seq, n, optimizer, compression, mesh):
    """repro.launch.train's planner and comm dicts for the same run."""
    cfg = jget_config(arch)
    decision = JP.choose_strategy(cfg, batch=batch, seq=seq, n_devices=n,
                                  optimizer=optimizer, compression=compression,
                                  mesh_axes=mesh)
    args = argparse.Namespace(batch=batch, seq=seq, compression=compression,
                              strategy=decision.strategy)
    return decision.to_dict(), jax_comm_estimate(cfg, args, n)


@pytest.mark.parametrize("n,mesh", [(4, {"data": 2, "model": 2}),
                                    (1, {"data": 1, "model": 1})])
def test_train_auto_dry_run_is_the_reference(n, mesh, capsys):
    """Full-width smollm-360m, adamw + int8_ef, 8 × 512: the reference's
    decision (at 4: dp, every strategy over the 1 GiB budget) and its comm
    estimate, printed as the reference prints them."""
    got = train.main(["--strategy", "auto", "--report-comm", "--dry-run",
                      "--devices", str(n), "--batch", "8", "--seq", "512",
                      "--compression", "int8_ef"] + CPU)
    out = capsys.readouterr().out
    planner, comm = _reference_auto("smollm-360m", 8, 512, n, "adamw",
                                    "int8_ef", mesh)
    assert got["planner"] == planner and got["comm"] == comm
    assert got["strategy"] == planner["strategy"]
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(got))
    assert f"planner: --strategy auto -> {planner['strategy']} (" in out
    assert f"comm estimate [{comm['calibration']}]: " \
           f"{comm['per_step_ms']:.3f} ms/step over {comm['mesh_axes']}" in out
    if n == 4:
        assert planner["strategy"] == "dp"
        assert "least-bad" in planner["reason"]


def test_train_auto_runs_on_a_cpu_pool(capsys):
    """--strategy auto over 2 CPU ranks: the planner's strategy is the one
    the ranks run, and the report carries planner and comm."""
    got = train.main(["--strategy", "auto", "--report-comm", "--reduced",
                      "--devices", "2", "--steps", "2", "--batch", "4",
                      "--seq", "16", "--compression", "int8_ef"] + CPU)
    capsys.readouterr()
    assert got["path"] == "sharded" and got["pool"]["ranks"] == 2
    assert got["strategy"] == got["planner"]["strategy"]
    assert got["comm"]["strategy"] == got["strategy"]
    assert len(got["losses"]) == 2 and np.all(np.isfinite(got["losses"]))
    assert [r["rank"] for r in got["ranks"]] == [0, 1]


# ---------------------------------------------------------------------------
# python -m repro_torch.perf.costmodel.calibrate
# ---------------------------------------------------------------------------

def test_calibrate_dry_run(capsys):
    plan_ = calibrate.main(["--dry-run", "--per-collective"])
    assert _last_json(capsys, "calibrate_plan") == plan_
    assert plan_["out"] == "" and plan_["per_collective"]


def test_calibrate_needs_out(capsys):
    with pytest.raises(SystemExit) as e:
        calibrate.main(["--rows", "x.json"])
    assert e.value.code == 2 and "--out" in capsys.readouterr().err


@pytest.mark.parametrize("flags,label", [([], "fitted:global"),
                                         (["--overlap"], "fitted:global+overlap")])
def test_calibrate_writes_out(flags, label, tmp_path, capsys):
    """Fitted from the checked-in lm rows, written to --out only, and
    loadable as ``$REPRO_CALIBRATION`` would load it."""
    out = tmp_path / "cal.json"
    cal = calibrate.main(["--rows", os.path.join(ART, "arch_sweep_lm.json"),
                          "--out", str(out), "--seeds", "1", "--maxiter", "20"]
                         + flags + CPU)
    assert sorted(os.listdir(tmp_path)) == ["cal.json"]
    loaded = Calibration.load(str(out))
    assert loaded.label == cal.label == label
    assert loaded.to_dict() == cal.to_dict()
    assert cal.meta["n_rows"] == 37
    assert f"wrote {out}" in capsys.readouterr().out


def test_planner_modules_import_neither_jax_nor_repro():
    """A fresh interpreter that imports the planner, its CLIs and what they
    import at call time holds no module of jax, jaxlib or repro (a pool rank
    imports ``launch.plan`` for its jobs)."""
    code = ("import sys\n"
            "import repro_torch.perf.planner, repro_torch.launch.plan\n"
            "import repro_torch.launch.train, repro_torch.perf.costmodel.calibrate\n"
            "import repro_torch.train.step, repro_torch.perf.sweep\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'repro'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": SRC},
                         check=True).stdout.strip()
    assert out == "[]"
