"""The step-time predictor (``repro_torch.core.predictor``) and the
``predict_scaling`` entry point against the reference's
(``repro.core.predictor``, ``examples/predict_scaling.py``): the cell
features of every arch × shape × chip count, the fit on dry-run rows by
its cost, and the launcher hooks on one set of constants."""
import json
import math

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.core import predictor as JP
from repro.core.generic_model import PerfModel as JaxPerfModel
from repro_torch.configs import ALL_SHAPES, ARCH_IDS, get_config, get_shape
from repro_torch.core import predictor as P
from repro_torch.core.generic_model import PerfModel

COST_RTOL = 0.10     # the port's best DE cost vs the reference's (test_torch_perfmodel)
RTOL = 1e-5
CHIPS = (1, 8, 256, 512)
FIT = dict(seeds=(0, 1, 2), maxiter=150)


@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_features_equal_reference(arch, shape):
    for n in CHIPS:
        assert (P.cell_features(get_config(arch), get_shape(shape), n)
                == JP.cell_features(jax_get_config(arch), jax_get_shape(shape), n))


def test_cell_spec_equals_reference():
    assert P.FAMILIES == JP.FAMILIES
    for k in ("numeric", "categorical", "extrinsic"):
        assert getattr(P.CELL_SPEC, k) == getattr(JP.CELL_SPEC, k)
    assert P.CELL_SPEC.n_params == JP.CELL_SPEC.n_params


@pytest.fixture(scope="module")
def rows_dir(tmp_path_factory):
    """24 OK rows (and a SKIP and a summary, both ignored) with a
    roofline-like t_step: compute over chips plus a per-chip floor."""
    d = tmp_path_factory.mktemp("dryrun_rows")
    rng = np.random.default_rng(0)
    archs = ("qwen2.5-3b", "smollm-360m", "gemma2-2b", "mamba2-370m",
             "deepseek-v3-671b", "whisper-tiny")
    n = 0
    for arch in archs:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            for chips in (256, 512):
                if (n % 3) == 2:
                    n += 1
                    continue
                f = P.cell_features(get_config(arch), get_shape(shape), chips)
                t = (6 * f["active_params_b"] * f["tokens_m"] * 1e15 / (chips * 989.4e12)
                     * (1 + 0.05 * rng.standard_normal()) + 2e-4)
                row = {"arch": arch, "shape": shape, "mesh": "pod", "status": "OK",
                       "n_chips": chips, "roofline": {"t_step": abs(t)}}
                (d / f"{arch}_{shape}_{chips}.json").write_text(json.dumps(row))
                n += 1
    (d / "x_skip.json").write_text(json.dumps({"arch": "qwen2.5-3b", "status": "SKIP"}))
    (d / "summary.json").write_text("[]")
    return str(d)


@pytest.fixture(scope="module")
def fits(rows_dir):
    got = P.StepTimePredictor.fit_from_dryrun(rows_dir, device="cpu", **FIT)
    want = JP.StepTimePredictor.fit_from_dryrun(rows_dir, **FIT)
    return got, want


def test_dryrun_samples_read_ok_rows_only(rows_dir):
    samples, times = P.dryrun_samples(rows_dir)
    assert len(samples) == len(times) == 24 and min(times) > 0


def test_fit_from_dryrun_reaches_reference_cost(fits):
    got, want = fits
    g, w = min(got.fit_result.seed_costs), min(want.fit_result.seed_costs)
    assert abs(g - w) <= COST_RTOL * w, (got.fit_result.seed_costs,
                                         want.fit_result.seed_costs)
    assert got.model.x.shape == (P.CELL_SPEC.n_params,)
    assert math.isfinite(got.scaling_power_chips())


def test_fit_needs_eight_rows(tmp_path):
    with pytest.raises(ValueError, match="too few"):
        P.StepTimePredictor.fit_from_dryrun(str(tmp_path), device="cpu")


def test_hooks_equal_reference_on_the_same_constants(fits):
    """With the reference's fitted x in both: every hook's number within
    1e-5 and ``rank_meshes``' order the same."""
    _, want = fits
    x = np.asarray(want.model.x)
    port = P.StepTimePredictor(model=PerfModel(P.CELL_SPEC, x, device="cpu"))
    ref = JP.StepTimePredictor(model=JaxPerfModel(JP.CELL_SPEC, x))
    for arch in ("qwen2.5-3b", "deepseek-v3-671b", "mamba2-370m", "zamba2-1.2b"):
        for shape in ("train_4k", "decode_32k"):
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            sh, jsh = get_shape(shape), jax_get_shape(shape)
            for n in (64, 256, 512):
                assert port.predict_step_seconds(cfg, sh, n) == pytest.approx(
                    ref.predict_step_seconds(jcfg, jsh, n), rel=RTOL)
                assert port.straggler_threshold(cfg, sh, n) == pytest.approx(
                    ref.straggler_threshold(jcfg, jsh, n), rel=RTOL)
            cands = [16, 64, 128, 256, 512, 1024]
            got, exp = port.rank_meshes(cfg, sh, cands), ref.rank_meshes(jcfg, jsh, cands)
            assert [c for c, _ in got] == [c for c, _ in exp]
            np.testing.assert_allclose([t for _, t in got], [t for _, t in exp], rtol=RTOL)


def test_predict_scaling_cli_on_the_cpu(rows_dir, capsys):
    from repro_torch.launch import predict_scaling
    out = predict_scaling.main(["--results-dir", rows_dir, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "fitted chips-scaling power" in text and "straggler threshold" in text
    assert set(out["archs"]) == set(predict_scaling.ARCHS)
    for v in out["archs"].values():
        assert all(math.isfinite(t) and t > 0 for t in v.values())


def test_predict_scaling_without_rows_says_how(tmp_path, capsys):
    from repro_torch.launch import predict_scaling
    assert predict_scaling.main(["--results-dir", str(tmp_path / "none"),
                                 "--device", "cpu"]) == {}
    assert "launch.dryrun --all" in capsys.readouterr().out
