"""The port's roofline table, roofline fit and hillclimb driver
(``repro_torch.launch.{roofline_table,roofline_fit,hillclimb}``) against the
reference's (``benchmarks/{roofline_table,roofline_fit,hillclimb}.py``), fed
the same dry-run row JSONs: every numeric column and both picks equal, the
fit within a stated band (the DE streams differ), the mesh ranking's order
equal, and the hillclimb variants and FAIL line the reference's."""
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import benchmarks.hillclimb as JH  # noqa: E402
import benchmarks.roofline_fit as JF  # noqa: E402
import benchmarks.roofline_table as JT  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.core import predictor as P  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.launch import roofline_fit as F  # noqa: E402
from repro_torch.launch import roofline_table as T  # noqa: E402

MAPE_TOL = 0.05      # the port's train MAPE vs the reference's, absolute
Q_CHIPS_TOL = 0.25   # the fitted chips power vs the reference's, absolute
ARCHS = ("qwen2.5-3b", "smollm-360m", "gemma2-2b", "mamba2-370m",
         "deepseek-v3-671b", "whisper-tiny")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MODE_COST = {"train": 3.0, "prefill": 1.0, "decode": 0.5}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's DE fits run many small ops: one intra-op thread keeps them
    fast when the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def rows_dir(tmp_path_factory):
    """36 OK rows over both meshes (the compute term a law of the generic
    model's form in the cell's features with 2 % noise: q_chips -1; the
    memory term 1.1x it, a collective term that leads on a fifth of the
    cells), a SKIP row, a FAIL row and a summary, which both readers
    skip."""
    d = tmp_path_factory.mktemp("dryrun_rows")
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh, chips in (("pod", 256), ("multipod", 512)):
                f = P.cell_features(get_config(arch), get_shape(shape), chips)
                compute = ((2.0 * f["active_params_b"] + MODE_COST[f["mode"]])
                           * 256 / chips * f["tokens_m"] ** 0.3 + 0.05) \
                    * (1 + 0.02 * rng.standard_normal())
                memory = compute * 1.1
                coll = compute * (1.3 if rng.uniform() < 0.2 else 0.05)
                terms = {"compute": compute, "memory": memory, "collective": coll}
                t = max(terms.values())
                model_flops = 6e9 * f["active_params_b"] * f["tokens_m"] * 1e6
                rf = {"flops": model_flops / chips * rng.uniform(1.5, 40.0),
                      "hbm_bytes": 1e12, "collective_bytes": 1e9, "n_chips": chips,
                      "compute_s": compute, "memory_s": memory, "collective_s": coll,
                      "bottleneck": max(terms, key=terms.get), "t_step": t,
                      "model_flops": model_flops,
                      "useful_fraction": model_flops / chips / 989.4e12 / t}
                row = {"arch": arch, "shape": shape, "mesh": mesh, "status": "OK",
                       "n_chips": chips, "compile_s": 0.0, "roofline": rf}
                (d / f"{arch}_{shape}_{mesh}.json").write_text(json.dumps(row))
    (d / "zamba2-1.2b_long_500k_pod.json").write_text(json.dumps(
        {"arch": "zamba2-1.2b", "shape": "long_500k", "mesh": "pod", "status": "SKIP",
         "reason": "full attention at 500k tokens is out of this benchmark's scope"}))
    (d / "llama4-scout-17b-a16e_train_4k_pod.json").write_text(json.dumps(
        {"arch": "llama4-scout-17b-a16e", "shape": "train_4k", "mesh": "pod",
         "status": "FAIL", "error": "Traceback: boom"}))
    (d / "summary.json").write_text("[]")
    return str(d)


def _cells(text):
    """{(arch, shape): [column strings]} of a table's rows, and its picks line."""
    out = {}
    for line in text.splitlines():
        parts = [p.strip() for p in line.strip().strip("|").split("|")]
        if len(parts) == 10 and parts[0] not in ("arch", "---"):
            out[(parts[0], parts[1])] = parts[2:]
    picks = [l for l in text.splitlines() if l.startswith("hillclimb picks")]
    return out, picks


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_roofline_table_equals_reference(rows_dir, mesh, monkeypatch):
    monkeypatch.setattr(JT, "DRYRUN_DIR", rows_dir)
    want, want_picks = _cells(JT.table(mesh))
    got, got_picks = _cells(T.table(mesh, rows_dir))
    assert set(got) == set(want) and len(got) == (20 if mesh == "pod" else 18)
    for cell, cols in want.items():
        # compute, memory, collective, bottleneck, t_step, ratio, useful, note
        assert got[cell] == cols, cell
    assert got_picks == want_picks and len(got_picks) == 1


def test_roofline_table_says_what_it_counts(rows_dir):
    text = T.table("pod", rows_dir)
    assert "MODEL_FLOPs/traced dots" in text and "memory_s (eager bytes)" in text
    assert "rank 0's program only" in text and "every row on every rank" in text
    assert T.NOTE == JT.NOTE
    assert "| SKIP |" in text and "| FAIL |" in text


def test_roofline_table_cli(rows_dir, capsys):
    out = T.main(["--mesh", "pod", "--results-dir", rows_dir])
    assert out in capsys.readouterr().out


@pytest.fixture(scope="module")
def fits(rows_dir):
    """Both drivers on the same rows: (port's result, reference's, the
    lines both printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got, want = F.roofline_fit(rows_dir, device="cpu"), JF.roofline_fit(rows_dir)
    return got, want, out.getvalue()


def test_roofline_fit_within_band_of_reference(fits):
    got, want, _ = fits
    assert got["status"] == want["status"] == "OK"
    assert abs(got["metrics"]["mape"] - want["metrics"]["mape"]) <= MAPE_TOL, (
        got["metrics"], want["metrics"])
    assert abs(got["q_chips"] - want["q_chips"]) <= Q_CHIPS_TOL, (
        got["q_chips"], want["q_chips"])
    assert [n for n, _ in got["ranked"]] == [n for n, _ in want["ranked"]]
    assert math.isfinite(got["straggler_threshold_s"])


def test_roofline_fit_emits_the_reference_lines(fits):
    """The port's three lines, then the reference's, alike but for the
    numbers."""
    lines = [l for l in fits[2].splitlines() if "," in l]
    keys = [[kv.split("=")[0] for kv in l.split(",")] for l in lines]
    assert [k[0] for k in keys] == ["roofline_fit", "mesh_ranking",
                                    "straggler_threshold"] * 2
    assert keys[:3] == keys[3:]
    assert lines[1] == lines[4]          # the ranking


def test_roofline_fit_skips_without_rows(tmp_path, capsys):
    assert F.roofline_fit(str(tmp_path), device="cpu") == {"status": "SKIP"}
    assert "repro_torch.launch.dryrun --all" in capsys.readouterr().out


def test_hillclimb_variants_are_the_reference(monkeypatch, tmp_path):
    assert H.VARIANTS == JH.VARIANTS
    from repro.dist.sharding import STRATEGIES as JS
    from repro_torch.dist.sharding import STRATEGIES
    assert "fsdp_pod" not in STRATEGIES and "fsdp_pod" not in JS


def test_hillclimb_runs_the_port_dryrun_and_prints_fail(monkeypatch, tmp_path, capsys):
    """Each variant is a subprocess of ``repro_torch.launch.dryrun`` with the
    variant's flags; a failing one gives the reference's FAIL line and is
    logged."""
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "ValueError: unknown strategy")

    monkeypatch.setattr(H.subprocess, "run", fake_run)
    log = tmp_path / "hc.jsonl"
    res = H.main(["--arch", "smollm-360m", "--shape", "train_4k", "--variants",
                  "baseline,fsdp_pod", "--log", str(log), "--device", "cpu"])
    assert [c[1:3] for c in seen] == [["-m", "repro_torch.launch.dryrun"]] * 2
    assert seen[1][-2:] == ["--strategy", "fsdp_pod"] and "--device" in seen[1]
    out = capsys.readouterr().out
    assert out.count("FAIL: ValueError: unknown strategy") == 2
    assert H.fmt(res["fsdp_pod"]) == JH.fmt(res["fsdp_pod"])
    assert len(log.read_text().splitlines()) == 2


def test_hillclimb_fmt_of_an_ok_row_is_the_reference():
    row = {"status": "OK", "compile_s": 0.0,
           "roofline": {"compute_s": 0.5, "memory_s": 1.25, "collective_s": 0.1,
                        "t_step": 1.25, "bottleneck": "memory", "useful_fraction": 0.01}}
    assert H.fmt(row) == JH.fmt(row)
