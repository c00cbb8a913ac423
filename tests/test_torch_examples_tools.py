"""The port's examples and tools (``repro_torch.examples.{quickstart,
serve_lm,train_lm}``, ``repro_torch.tools.{arch_smoke,calibration_smoke}``)
on the CPU against the reference's (``examples/``, ``tools/``): the
quickstart's own assertion at a reduced sample count, the serving example,
the training example's checkpoint and resume, and the tools' cells, schema
checks and plan against the reference tools' constants (read from their
source: importing a reference tool would set the process's XLA flags)."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart, serve_lm, train_lm
from repro_torch.tools import arch_smoke, calibration_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
QUICK_SAMPLES = 300      # the quickstart's fit split here (its default: 900)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's DE fits run many small ops: one intra-op thread keeps them
    fast when the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _constants(path, *names):
    """The literal values assigned to ``names`` at the top of a source file."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) in names:
            out[node.targets[0].id] = ast.literal_eval(node.value)
    assert set(out) == set(names), out
    return out


def test_quickstart_recovers_ideal_scaling(capsys):
    """The example's own assertion (q_gpus within 0.15 of -1) at a reduced
    fit split, its law and split the reference's."""
    result = quickstart.main(["--device", "cpu", "--samples", str(QUICK_SAMPLES)])
    q = result.model.scaling_powers()["gpus"][0]
    assert abs(q + 1.0) < 0.15
    assert "OK: recovered q_gpus" in capsys.readouterr().out
    assert np.isfinite(result.test_metrics["mape"])


def test_serve_lm_example_on_the_cpu():
    served = serve_lm.main(["--device", "cpu", "--gen", "4"])
    rep = served.report
    assert rep["arch"] == "gemma2-2b" and rep["batch"] == 4 and rep["generated"] == 4
    assert tuple(served.tokens.shape) == (4, 4)
    assert np.isfinite(served.logits.float().numpy()).all()


def test_train_lm_example_saves_and_resumes(tmp_path, capsys):
    """A run of the example's training that dies at step 55 (after its step-50
    checkpoint), then the example on the same directory: it resumes from
    step 50 and finishes."""
    ckpt = str(tmp_path / "ckpt")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    code = ("from repro_torch.examples.train_lm import train_argv\n"
            "from repro_torch.launch.train import main\n"
            f"main(train_argv('smollm-360m', 60, {ckpt!r}, 'cpu') + "
            "['--die-at-step', '55'])\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 42, r.stderr[-2000:]
    assert "ckpt_50.npz" in os.listdir(ckpt), os.listdir(ckpt)
    report = train_lm.main(["--steps", "60", "--ckpt-dir", ckpt, "--device", "cpu"])
    assert "resumed from step 50" in capsys.readouterr().out
    assert len(report["losses"]) == 10 and np.isfinite(report["losses"]).all()
    assert "--ckpt-every" in train_lm.train_argv("a", 1, "d", "cpu")
    assert train_lm.CKPT_EVERY == 50


def test_arch_smoke_cells_are_the_reference():
    ref = _constants("tools/arch_smoke.py", "SMOKE_CELLS")
    assert arch_smoke.SMOKE_CELLS == ref["SMOKE_CELLS"]


def test_arch_smoke_checks_a_row():
    """``check_row`` takes a measured token row and refuses one without
    the sharded column."""
    from repro_torch.perf.features import get_spec
    aspec = get_spec("lm")
    feats = {k: 1 for k in aspec.spec.numeric}
    feats.update(batch_size=8, seq_len=16)
    row = {"family": "lm", "norm_unit": "token", "t_measured_sharded": 3.0,
           "measured_ms": 2.0, "comm_ms": 0.5, "sharded_skip": None, "features": feats}
    arch_smoke.check_row(row, "lm", aspec)
    with pytest.raises(AssertionError):
        arch_smoke.check_row({**row, "t_measured_sharded": None}, "lm", aspec)


def test_arch_smoke_plan_runs():
    out = arch_smoke.plan_runs()
    plan = json.loads([l for l in out.splitlines() if "arch_sweep_plan" in l][-1])
    assert plan["arch_sweep_plan"]


def test_calibration_smoke_schema_is_the_reference(tmp_path):
    ref = _constants("tools/calibration_smoke.py", "REQUIRED_TOP", "REQUIRED_LINK",
                     "REQUIRED_META")
    for k, v in ref.items():
        assert getattr(calibration_smoke, k) == v
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION, fit_calibration
    rows = [{"features": {"n_devices": n, "batch_size": 16, "strategy": s,
                          "wire_bits": 8, "compression": "int8"},
             "mode": "jit", "measured_ms": 1.0, "comm_ms": 0.0, "param_bytes": 246_000,
             "act_bytes": 4096, "t_measured_sharded": 1.0 + 0.3 * n,
             "sharded_skip": None, "calibration": "default"}
            for s in ("dp", "fsdp", "tp", "fsdp_tp") for n in (2, 4)]
    cal = fit_calibration(rows, per_collective=True, seeds=(0,), maxiter=20,
                          source="calibration_smoke", device="cpu")
    path = str(tmp_path / "cal.json")
    cal.save(path)
    blob = calibration_smoke.check_artifact(path)
    assert blob["meta"]["n_rows"] == len(rows)
    DEFAULT_CALIBRATION.save(str(tmp_path / "default.json"))
    with pytest.raises(AssertionError):
        blob["meta"].pop("n_rows")
        with open(path, "w") as f:
            json.dump(blob, f)
        calibration_smoke.check_artifact(path)
