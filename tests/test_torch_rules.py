"""Rules of the port: what it imports, where it runs, and the serve and train
entry points' reports."""
import ast
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import nvcc
from repro_torch.kernels import quantize as Q
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models.attention import AttnSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
REFERENCE_REPORT_KEYS = {  # repro/launch/serve.py's report
    "arch", "batch", "prompt_len", "generated", "strategy", "devices", "mesh",
    "prefill_s", "decode_s", "decode_tok_per_s", "sample_tokens"}
REFERENCE_TRAIN_KEYS = {  # repro/launch/train.py's report, single device
    "arch", "steps", "first_loss", "final_loss", "wall_s", "losses",
    "strategy", "mesh"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10
    bad = [(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in ("jax", "jaxlib", "repro")]
    assert not bad, bad


ARCH_SWEEP_MODULES = ("repro_torch.obs.trace", "repro_torch.perf.planner.space",
                      "repro_torch.launch.arch_sweep", "repro_torch.perf.sweep")


@functools.lru_cache(maxsize=None)
def _roots_after_importing(modules, also):
    """The roots among jax, jaxlib and repro that a fresh interpreter holds
    after importing ``modules`` and ``also`` (what they import at call
    time)."""
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules + also)
            + "print(sorted({m.split('.')[0] for m in sys.modules}"
              " & {'jax', 'jaxlib', 'repro'}))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": SRC},
                          check=True).stdout.strip()


@pytest.mark.parametrize("module", ARCH_SWEEP_MODULES)
def test_arch_sweep_modules_import_neither_jax_nor_repro(module):
    """The arch sweep's modules are among the scanned files, and importing
    them in a fresh interpreter loads no module of jax, jaxlib or repro."""
    path = os.path.join(PORT, *module.split(".")[1:]) + ".py"
    assert path in _port_files()
    # the step, the fits, the calibration
    assert _roots_after_importing(ARCH_SWEEP_MODULES, (
        "repro_torch.train.step", "repro_torch.core.fit",
        "repro_torch.perf.costmodel.calibrate")) == "[]"


DRYRUN_MODULES = ("repro_torch.launch.dryrun", "repro_torch.perf.roofline",
                  "repro_torch.perf.op_analysis", "repro_torch.core.predictor",
                  "repro_torch.launch.predict_scaling", "repro_torch.launch.specs",
                  "repro_torch.launch.mesh")


@pytest.mark.parametrize("module", DRYRUN_MODULES)
def test_dryrun_modules_import_neither_jax_nor_repro(module):
    """The dry-run path's modules (dry-run, roofline, op analysis,
    predictor, predict_scaling, specs, mesh) are among the scanned files,
    and importing them in a fresh interpreter loads no module of jax,
    jaxlib or repro."""
    path = os.path.join(PORT, *module.split(".")[1:]) + ".py"
    assert path in _port_files()
    # the step, the serving plan, the fit, the predictions
    assert _roots_after_importing(DRYRUN_MODULES, (
        "repro_torch.train.step", "repro_torch.train.serve",
        "repro_torch.core.fit", "repro_torch.perf.predict")) == "[]"


def test_port_has_no_jax_in_sources():
    """No string route to JAX either (``importlib.import_module("jax")``)."""
    for f in _port_files():
        src = open(f).read()
        assert "import_module(\"jax" not in src and "import_module('jax" not in src, f


def test_serve_without_device_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would serve")
    from repro_torch.launch import serve
    before = FA.LAUNCHES
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "2", "--gen", "1"])
    assert FA.LAUNCHES == before


def test_init_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as MD
    with pytest.raises(RuntimeError, match="cuda"):
        MD.init_model(reduced(get_config("qwen2.5-3b")))


def test_kernel_wrapper_refuses_cpu_tensors():
    """Only ops.attention sends CPU tensors to the plain version; the
    kernel's own wrapper raises before building or launching anything."""
    q = torch.zeros(1, 2, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    pos = torch.arange(4, dtype=torch.int32)
    before = FA.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, k, pos[2:], pos, AttnSpec())
    assert FA.LAUNCHES == before


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen", "3"],
    ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--batch", "1",
     "--prompt-len", "3", "--gen", "2", "--seed", "5"],
    ["--arch", "mamba2-370m", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "5", "--gen", "3"],
    ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "5", "--gen", "3"],
    ["--arch", "whisper-tiny", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "5", "--gen", "3"],
    ["--arch", "nemotron-4-15b", "--reduced", "--device", "cpu", "--batch", "1",
     "--prompt-len", "3", "--gen", "2"],
    ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "5", "--gen", "3"],
    ["--arch", "llama4-scout-17b-a16e", "--reduced", "--device", "cpu", "--batch",
     "2", "--prompt-len", "5", "--gen", "3"],
    ["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "5", "--gen", "3"],
    ["--arch", "internvl2-76b", "--reduced", "--device", "cpu", "--batch", "2",
     "--prompt-len", "20", "--gen", "3"],
])
def test_serve_cpu_report(argv, capsys):
    from repro_torch.launch import serve
    served = serve.main(argv)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert REFERENCE_REPORT_KEYS <= set(report)
    assert report == served.report
    gen = int(argv[argv.index("--gen") + 1])
    B = int(argv[argv.index("--batch") + 1])
    assert tuple(served.tokens.shape) == (B, gen)
    assert report["generated"] == gen and report["devices"] == 1
    assert report["sample_tokens"] == served.tokens[0, :8].tolist()
    assert torch.isfinite(served.logits.float()).all()
    assert ("encode_s" in report) == ("whisper-tiny" in argv)
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_size
    cfg = _reduced_cfg(argv)
    assert report["tree_params"] == tree_size(MD.init_model(cfg, device="cpu"))
    assert report["param_count"] == cfg.param_count()


def _reduced_cfg(argv, default="qwen2.5-3b"):
    """The reduced config an entry point runs for ``argv`` (``default``: its
    default ``--arch``)."""
    from repro_torch.configs import get_config, reduced
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else default
    return reduced(get_config(arch))


def test_serve_dry_run(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--dry-run"]) is None
    plan = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert plan["dry_run"] and plan["arch"] == "qwen2.5-3b"


def test_kernel_source_is_for_hopper():
    assert "arch=compute_90a,code=sm_90a" in FA.NVCC_FLAGS
    src = open(FA.SOURCE).read()
    assert "__global__" in src and "src/repro/kernels/flash_attention.py" in src
    assert FA.library_path().startswith(FA.BUILD_DIR)


def _codec_launches():
    return Q.ABSMAX_LAUNCHES, Q.QUANTIZE_LAUNCHES, Q.DEQUANTIZE_LAUNCHES


@pytest.mark.parametrize("call", ["absmax", "quantize", "dequantize"])
def test_codec_wrappers_refuse_cpu_tensors(call):
    """Only kernels.ops sends CPU tensors to the plain versions; the codec's
    own wrappers raise before building or launching anything."""
    x = torch.ones(8)
    acc = torch.zeros(1)
    before = _codec_launches()
    fn = {"absmax": lambda: Q.absmax_into(x, acc),
          "quantize": lambda: Q.quantize_with(x, acc),
          "dequantize": lambda: Q.dequantize_int8(x.to(torch.int8),
                                                  torch.ones(()))}[call]
    with pytest.raises((ValueError, RuntimeError), match="CUDA|cuda"):
        fn()
    assert _codec_launches() == before


def test_codec_source_is_for_hopper():
    assert "arch=compute_90a,code=sm_90a" in nvcc.NVCC_FLAGS
    assert "--use_fast_math" not in nvcc.NVCC_FLAGS
    src = open(Q.SOURCE).read()
    assert src.count("__global__") == 3
    assert "src/repro/kernels/quantize.py" in src
    for fn in ("__fdiv_rn", "rintf", "atomicMax"):
        assert fn in src, fn
    assert Q.library_path().startswith(nvcc.BUILD_DIR)
    assert os.path.basename(Q.library_path()).startswith("libquantize-")


def test_train_without_device_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would train")
    from repro_torch.launch import train
    before = (FA.LAUNCHES, _codec_launches())
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1", "--batch", "2", "--seq", "8"])
    assert (FA.LAUNCHES, _codec_launches()) == before


def test_sharded_train_without_device_flag_needs_cuda():
    """A world of ranks on the card by default: no CUDA, no pool started."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would train")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1", "--devices", "4"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_mamba2_without_device_flag_needs_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    from repro_torch.launch import serve, train
    before = (FA.LAUNCHES, _codec_launches(), SSD.LAUNCHES)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "train":
            train.main(["--arch", "mamba2-370m", "--reduced", "--steps", "1",
                        "--batch", "2", "--seq", "8"])
        else:
            serve.main(["--arch", "mamba2-370m", "--reduced", "--batch", "1",
                        "--prompt-len", "2", "--gen", "1"])
    assert (FA.LAUNCHES, _codec_launches(), SSD.LAUNCHES) == before


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-tiny", "zamba2-1.2b",
                                  "llama4-scout-17b-a16e", "deepseek-v3-671b",
                                  "internvl2-76b"])
@pytest.mark.parametrize("entry", ["train", "serve"])
def test_new_archs_without_device_flag_need_cuda(entry, arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    from repro_torch.launch import serve, train
    before = (FA.LAUNCHES, _codec_launches())
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "train":
            train.main(["--arch", arch, "--reduced", "--steps", "1", "--batch", "2",
                        "--seq", "8", "--remat", "dots"])
        else:
            serve.main(["--arch", arch, "--reduced", "--batch", "1",
                        "--prompt-len", "2", "--gen", "1"])
    assert (FA.LAUNCHES, _codec_launches()) == before


def _ssd_cpu_inputs():
    x = torch.zeros(1, 32, 2, 8)
    dt = torch.zeros(1, 32, 2)
    A = torch.full((2,), -1.0)
    B = torch.zeros(1, 32, 1, 8)
    return x, dt, A, B, B.clone(), torch.ones(2)


@pytest.mark.parametrize("call", ["wrapper", "autograd"])
def test_ssd_kernel_refuses_cpu_tensors(call):
    """Only the plain version takes CPU tensors: the kernel's wrapper raises
    before building or launching anything, and the custom op that autograd
    goes through (``ssd_scan_op``) sends them to its CPU implementation,
    ``ssd_plain``, launching nothing."""
    ins = _ssd_cpu_inputs()
    before = SSD.LAUNCHES
    if call == "wrapper":
        with pytest.raises(ValueError, match="CUDA"):
            SSD.ssd_scan(*ins, 32)
    else:
        got = SSD.ssd_scan_op(*ins, 32)
        want = SSD.ssd_plain(*ins, chunk=32, return_state=True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert SSD.LAUNCHES == before


def test_ssd_wrapper_checks_shapes_before_device_work():
    """The wrapper's shape, dtype and shared-memory checks come before its
    device check; run on meta tensors, which it then refuses as not CUDA."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    x, dt, A, B, C, D = (meta(1, 32, 2, 8), meta(1, 32, 2), meta(2),
                         meta(1, 32, 1, 8), meta(1, 32, 1, 8), meta(2))
    for args, chunk, what in (
            ((x, dt, A, B, C, D), 24, "multiple of chunk"),
            ((x.half(), dt, A, B.half(), C.half(), D), 32, "fp32 or bf16"),
            ((x, dt, A, B.bfloat16(), C, D), 32, "fp32 or bf16"),
            ((x, dt.bfloat16(), A, B, C, D), 32, "dt must be fp32"),
            ((x, dt, A, meta(1, 32, 1, 8)[..., :4], C, D), 32, "do not agree")):
        with pytest.raises(ValueError, match=what):
            SSD.ssd_scan(*args, chunk)
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan(x, dt, A, B, C, D, 32)
    assert SSD.smem_bytes(64, 128, 256) <= SSD.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        SSD.ssd_scan(meta(1, 2048, 1, 128), meta(1, 2048, 1), meta(1),
                     meta(1, 2048, 1, 256), meta(1, 2048, 1, 256), meta(1), 2048)


def test_ssd_source_is_for_hopper():
    assert "arch=compute_90a,code=sm_90a" in nvcc.NVCC_FLAGS
    src = open(SSD.SOURCE).read()
    assert src.count("__global__") == 1
    assert "src/repro/kernels/ssd_scan.py" in src
    for needle in ("cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "cudaGetLastError", "extern \"C\" int ssd_scan_forward"):
        assert needle in src, needle
    assert f"kTile = {SSD.TILE};" in src
    assert f"kMaxP = {SSD.MAX_HEAD_DIM}" in src and str(SSD.MAX_SMEM) in src
    assert SSD.library_path().startswith(nvcc.BUILD_DIR)
    assert os.path.basename(SSD.library_path()).startswith("libssd_scan-")
    # each design's kernel and its source: cuda_core above, mma here
    assert SSD.SOURCES == (SSD.SOURCE, SSD.MMA_SOURCE)
    assert "ssd_scan_kernel" in src
    mma = open(SSD.MMA_SOURCE).read()
    assert mma.count("__global__") == 1 and "ssd_scan_mma_kernel" in mma
    assert "src/repro/kernels/ssd_scan.py" in mma
    for needle in ("cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "cudaGetLastError", "extern \"C\" int ssd_scan_mma_forward",
                   "#include \"mma_sm90.cuh\"", "mma_bf16(", "ldsm_x4_trans(",
                   "cp_async16("):
        assert needle in mma, needle
    assert f"kRowTile = {SSD.MMA_ROWS};" in mma
    assert f"kMaxState = {SSD.MMA_MAX_STATE};" in mma and str(SSD.MAX_SMEM) in mma
    assert os.path.basename(SSD.library_path(SSD.MMA_SOURCE)).startswith(
        "libssd_scan_mma-")


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
     "8", "--compression", "int8_ef"],
    ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
     "8", "--optimizer", "adafactor", "--microbatches", "2", "--remat",
     "full", "--dtype", "float32", "--seed", "3"],
    ["--arch", "mamba2-370m", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "40", "--compression", "int8_ef"],
    ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "16", "--compression", "int8_ef", "--remat", "dots"],
    ["--arch", "whisper-tiny", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "16", "--compression", "int8_ef", "--remat", "dots",
     "--optimizer", "adafactor"],
    ["--arch", "nemotron-4-15b", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "8", "--optimizer", "sgd"],
    ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "40", "--compression", "int8_ef", "--remat", "full"],
    ["--arch", "llama4-scout-17b-a16e", "--reduced", "--device", "cpu", "--steps",
     "2", "--batch", "2", "--seq", "16", "--optimizer", "sgd"],
    ["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "16", "--compression", "int8_ef", "--optimizer",
     "adafactor"],
    ["--arch", "internvl2-76b", "--reduced", "--device", "cpu", "--steps", "2",
     "--batch", "2", "--seq", "24", "--compression", "int8_ef", "--remat", "dots"],
])
def test_train_cpu_report(argv, capsys):
    from repro_torch.launch import train
    report = train.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report
    assert REFERENCE_TRAIN_KEYS | {"device", "step_ms", "tokens_per_s"} <= set(report)
    steps = int(argv[argv.index("--steps") + 1])
    assert report["steps"] == steps and len(report["losses"]) == steps
    assert report["first_loss"] == report["losses"][0]
    assert report["final_loss"] == pytest.approx(sum(report["losses"]) / steps)
    assert report["device"] == "cpu" and report["mesh"] == [1, 1]
    assert report["step_ms"] > 0 and report["tokens_per_s"] > 0
    cfg = _reduced_cfg(argv, default="smollm-360m")
    assert report["param_count"] == cfg.param_count() and report["tree_params"] > 0
    assert len(report["aux"]) == steps
    assert all(a > 0 for a in report["aux"]) == (cfg.moe is not None)
    assert ("mtp_ce" in report) == bool(cfg.mtp_depth)


def test_train_dry_run(capsys):
    from repro_torch.launch import train
    plan = train.main(["--device", "cpu", "--dry-run"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == plan
    assert plan["dry_run"] and plan["arch"] == "smollm-360m"
    # one device: the reference's gspmd path, which on one device is the
    # single-device step
    assert plan["path"] == "gspmd"
    assert plan["path_reason"] == "auto fallback: single device"
    assert plan["mesh"] == [1, 1] and plan["devices"] == 1


def test_new_modules_are_under_the_import_rule():
    files = {os.path.relpath(f, PORT) for f in _port_files()}
    assert {"launch/mesh.py", "launch/specs.py", "train/step.py",
            "dist/sharding.py", "dist/pool.py"} <= files


def test_train_sharded_cpu_report(capsys):
    """The sharded step over a world of 8 CPU ranks: plan_remesh(8)'s mesh,
    the pool in the report, one loss a step, every rank's regions timed."""
    from repro_torch.launch import train
    report = train.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                         "--devices", "8", "--strategy", "fsdp_tp",
                         "--compression", "int8_ef", "--steps", "3", "--seq", "16"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert REFERENCE_TRAIN_KEYS | {"path", "path_reason", "pool", "ranks"} <= set(report)
    assert report["path"] == "sharded" and report["path_reason"] == "auto"
    assert report["mesh"] == [2, 4] and report["strategy"] == "fsdp_tp"
    assert report["pool"] == {"ranks": 8, "backend": "gloo", "cards": 0}
    assert len(report["losses"]) == 3 and report["step_ms"] > 0
    assert [r["rank"] for r in report["ranks"]] == list(range(8))
    for r in report["ranks"]:
        assert r["device"] == "cpu"
        assert set(r["regions_ms"]) == {"gather_params", "grad_compute",
                                        "grad_reduce", "update"}


def test_train_pool_is_the_mesh(capsys):
    """A world that is not a power of two opens only the mesh's ranks:
    --devices 3 is plan_remesh(3)'s mesh (1, 2), a pool of 2."""
    from repro_torch.launch import train
    report = train.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                         "--devices", "3", "--steps", "1", "--seq", "16"])
    assert report["path"] == "sharded" and report["mesh"] == [1, 2]
    assert report["pool"] == {"ranks": 2, "backend": "gloo", "cards": 0}
    assert [r["rank"] for r in report["ranks"]] == [0, 1]


@pytest.mark.parametrize("argv,devices,mode,reason", [
    (["--strategy", "dp", "--optimizer", "adafactor"], 8, [],
     "auto fallback: adafactor needs full-dim factored moments"),
    (["--batch", "3"], 4, [], "auto fallback: batch 3 not divisible over the batch axes"),
    ([], 4, ["--mode", "gspmd"], "requested"),
])
def test_train_gspmd_over_devices_runs(argv, devices, mode, reason, capsys):
    """No silent switch: the reference's path reason, then the GSPMD step
    over the ranks (not the single device), whose fp32 losses are the
    single-device step's."""
    from repro_torch.launch import train
    base = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "16",
            "--dtype", "float32", *argv]
    report = train.main(base + ["--devices", str(devices), *mode])
    out = capsys.readouterr().out
    assert f"path=gspmd (most-square fallback; {reason}" in out
    assert report["path"] == "gspmd" and report["path_reason"].startswith(reason)
    assert report["pool"]["ranks"] == devices and len(report["ranks"]) == devices
    assert all(r["transient_bytes"] is not None for r in report["ranks"])
    single = train.main(base)
    assert single["path_reason"] == "auto fallback: single device"
    np.testing.assert_allclose(report["losses"], single["losses"], rtol=1e-5)


def test_train_sharded_mode_needs_a_world(capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="impossible: single device"):
        train.main(["--reduced", "--device", "cpu", "--mode", "sharded"])


def _port_launches():
    return (FA.LAUNCHES, _codec_launches(), SSD.LAUNCHES)


def test_fit_perfmodel_without_device_flag_needs_cuda(tmp_path):
    """The paper pipeline defaults to the card: without --device it raises
    on a machine with no CUDA device, before it measures or writes a row."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would sweep")
    from repro_torch.launch import fit_perfmodel
    rows = tmp_path / "rows.json"
    before = _port_launches()
    with pytest.raises(RuntimeError, match="cuda"):
        fit_perfmodel.main(["--trials", "2", "--mode", "eager",
                            "--rows-out", str(rows)])
    assert not rows.exists()
    assert _port_launches() == before


def test_fit_perfmodel_cpu_report(tmp_path, capsys):
    from repro_torch.launch import fit_perfmodel
    rows_out = tmp_path / "rows.json"
    before = _port_launches()
    report = fit_perfmodel.main(["--device", "cpu", "--mode", "eager",
                                 "--trials", "12", "--seed", "1",
                                 "--rows-out", str(rows_out)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == report
    assert "== LeNet-5 generic model (L2) ==" in out
    assert "== scaling analysis (q = -1 ideal) ==" in out
    assert report["device"] == "cpu" and report["mode"] == "eager"
    assert report["rows"] == {"eager": {"ok": 12, "error": 0}}
    assert (report["n_fit"], report["n_test"]) == (7, 5)
    assert report["sweep_s"] > 0 and report["fit_s"] > 0
    assert report["warmup_s"]["max"] >= report["warmup_s"]["median"] > 0
    assert set(report["test_mape"]) == {"generic", "random_forest", "svr"}
    rows = json.loads(rows_out.read_text())
    assert len(rows) == 12 and all(r["mode"] == "eager" for r in rows)
    assert _port_launches() == before          # the pipeline runs no kernel


def test_pool_ranks_import_neither_jax_nor_repro():
    """A spawned rank of the port's pool imports torch and the port only,
    though the caller (this test process) has JAX loaded; a rank that raises
    fails the job with its rank named, and the pool goes on."""
    import _torch_pool_jobs as jobs
    from repro_torch.dist.pool import Pool, RankError
    with Pool(world=2, device="cpu") as pool:
        roots = pool.run(jobs.imported_roots, mesh={"data": 2})
        with pytest.raises(RankError, match="rank 1: ValueError: job failed"):
            pool.run(jobs.raise_on, 1, mesh={"data": 2})
        assert pool.run(jobs.raise_on, 5, mesh={"data": 2}) == [0, 1]
    assert "jax" in roots[0] and roots[1] == []


def test_pool_isolates_a_rank_that_fails_in_a_collective():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the job
    fails with rank 1's traceback within seconds (not the collectives'
    300 s timeout), and the next job runs on a fresh world (new processes)."""
    import time

    import _torch_pool_jobs as jobs
    from repro_torch.dist.pool import Pool, RankError
    with Pool(world=2, device="cpu") as pool:
        before = pool.run(jobs.pid, mesh={"data": 2})
        t0 = time.monotonic()
        with pytest.raises(RankError) as err:
            pool.run(jobs.raise_in_collective, 1, mesh={"data": 2})
        assert time.monotonic() - t0 < 30
        assert "rank 1: ValueError: rank 1 left its peers" in str(err.value)
        assert "in raise_in_collective" in str(err.value)     # the traceback
        after = pool.run(jobs.pid, mesh={"data": 2})
        assert pool.starts == 2
        assert after[0] == before[0] and not set(after[1:]) & set(before[1:])


def test_fit_perfmodel_sharded_needs_a_compiled_mode(capsys):
    from repro_torch.launch import fit_perfmodel
    with pytest.raises(SystemExit):
        fit_perfmodel.main(["--sharded", "--mode", "eager", "--device", "cpu"])
    assert "compiled iterations" in capsys.readouterr().err
