"""The dry-run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``): the cells and shapes, the production mesh, the
constraint and parameter specs, the collective recorder, and a traced
cell's flops, argument bytes and row keys.

The port traces rank 0's program of a mesh on fake tensors in a world on
the ``"fake"`` backend, here on device ``cpu`` (the CPU build of torch has
no device guard for fake CUDA tensors, so autograd cannot run on them).
The reference lowers and compiles on host devices in one subprocess for
the whole file, under a plain ``jax.sharding.Mesh`` (``jax.make_mesh``
builds Explicit axes in this image's jax, where ``maybe_constrain``
raises). A fake world lives in this process between a test's start and
end only: a ``Pool``'s rank 0 is this process too.
"""
import collections
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, TrainConfig,
                                 cell_is_runnable, get_config, get_shape, reduced)
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as SH
from repro_torch.dist.pool import Pool
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_pool_jobs as jobs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TINY = dict(d_model=64, vocab=512)
TINY_TRAIN = ShapeConfig("tiny_train", 64, 8, "train")
MESHES = {"1x1x1": {"pod": 1, "data": 1, "model": 1},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
FLOPS_RTOL = 0.01
CONSTRAIN_MESHES = {"1x1": (1, 1), "2x2": (2, 2), "2x2x2": (2, 2, 2)}
# (shape, entries): "B" is the BATCH sentinel, a list a joint entry
CONSTRAIN_CASES = [
    ((8, 6, 4), ["B", "model", ["data", "model"]]),
    ((8, 16, 64), ["B", None, "model"]),
    ((3, 16), ["B", "model"]),
    ((4, 6), ["data", "data"]),
    ((16, 4, 2), [["pod", "data"], "model", "model"]),
    ((2, 2, 2, 2), ["pod", "data", "model", "B"]),
    ((6,), ["model"]),
]
SPEC_ARCHS = ("qwen2.5-3b", "mamba2-370m", "deepseek-v3-671b")

REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import (ALL_SHAPES, ARCH_IDS, cell_is_runnable, get_config,
                           get_shape, reduced)
from repro.configs.base import ShapeConfig
from repro.dist import sharding as JSH
from repro.models import model as JMD
import repro.launch.dryrun as D

cases = json.loads(sys.argv[1])
def mesh_of(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)
out = {"runnable": {f"{a}/{s.name}": list(cell_is_runnable(get_config(a), s))
                    for a in ARCH_IDS for s in ALL_SHAPES},
       "shapes": {s.name: dataclasses.asdict(get_shape(s.name)) for s in ALL_SHAPES}}
ent = lambda e: JSH.BATCH if e == "B" else tuple(e) if isinstance(e, list) else e
out["constrain"] = {}
for name, shape in cases["meshes"].items():
    mesh = mesh_of(tuple(shape))
    with mesh:
        out["constrain"][name] = [
            JSH.spec_to_json(JSH.maybe_constrain(jnp.zeros(s), *map(ent, e)).sharding.spec)
            for s, e in cases["constrain"]]
out["param_shardings"] = {}
for arch in cases["spec_archs"]:
    shapes = jax.eval_shape(lambda: JMD.init_model(jax.random.PRNGKey(0),
                                                   reduced(get_config(arch))))
    for name, shape in cases["meshes"].items():
        tree = JSH.param_shardings(shapes, mesh_of(tuple(shape)), "fsdp_tp")
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
        out["param_shardings"][f"{arch}/{name}"] = {
            jax.tree_util.keystr(p): JSH.spec_to_json(s.spec) for p, s in leaves}
out["rows"] = {}
for key, arch, mode, ms in cases["cells"]:
    D.get_config = lambda a, arch=arch: reduced(get_config(arch), d_model=64, vocab=512)
    D.get_shape = lambda s, mode=mode: ShapeConfig("tiny_" + mode, 64, 8, mode)
    D.make_production_mesh = lambda multi_pod=False, ms=ms: mesh_of(tuple(ms))
    out["rows"][key] = D.run_cell(arch, "tiny_" + mode, remat="none", verbose=False)
print(json.dumps(out))
"""
CELLS = [("qwen_train_1x1x1", "qwen2.5-3b", "train", (1, 1, 1)),
         ("qwen_train_2x2x2", "qwen2.5-3b", "train", (2, 2, 2)),
         ("qwen_prefill_1x1x1", "qwen2.5-3b", "prefill", (1, 1, 1)),
         ("mamba2_prefill_1x1x1", "mamba2-370m", "prefill", (1, 1, 1)),
         ("mamba2_train_1x1x1", "mamba2-370m", "train", (1, 1, 1))]


@pytest.fixture(scope="module")
def reference_run():
    cases = {"meshes": CONSTRAIN_MESHES, "constrain": CONSTRAIN_CASES,
             "spec_archs": SPEC_ARCHS, "cells": CELLS}
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(cases)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    out, err = reference_run.communicate(timeout=600)
    assert reference_run.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def no_fake_world_after():
    """A test's fake world ends with it."""
    yield
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _mesh(axes):
    """Rank 0's view of a mesh of ``axes`` in a fake world of its size."""
    D.fake_world(SH.mesh_size(axes))
    return SH.Mesh(axes, 0, SH.LazyGroups())


def _trace(arch, mode, axes, strategy="fsdp_tp"):
    """(row fields, stats) of rank 0's tiny cell on ``axes``."""
    cfg = reduced(get_config(arch), **TINY)
    shape = ShapeConfig("tiny_" + mode, 64, 8, mode)
    fields, _, stats = D.trace_cell(cfg, shape, _mesh(axes),
                                    TrainConfig(remat_policy="none"), strategy,
                                    device="cpu")
    return fields, stats


def _card_ops(monkeypatch):
    """Route the model's attention and SSD scan through the custom ops on
    the CPU, as every call on the card goes: the trace then counts the
    ops' flop formulas and their backward's plain recompute."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    monkeypatch.setattr(ops, "attention", FA.attention)
    monkeypatch.setattr(ops, "ssd_chunked", lambda x, dt, A, B, C, Dd, chunk=256:
                        SSD.ssd_scan_op(x, dt, A, B, C, Dd, chunk))


# ---------------------------------------------------------------------------
# Port-only checks first: the reference compiles meanwhile
# ---------------------------------------------------------------------------

def test_reference_started(reference_run):
    assert reference_run.poll() in (None, 0)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_make_production_mesh_coordinates_and_groups(multi_pod):
    """16 x 16 (data, model), or 2 x 16 x 16 with pod; a rank's coordinates
    major axis first; a group is made only when asked for, over the ranks
    sharing the rank's other coordinates, and only in a world."""
    mesh = make_production_mesh(multi_pod=multi_pod, rank=37)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert mesh.shape == want and mesh.size == (512 if multi_pod else 256)
    assert mesh.coords == ({"pod": 0, "data": 2, "model": 5} if multi_pod
                           else {"data": 2, "model": 5})
    with pytest.raises(RuntimeError, match="world"):
        mesh.group("model")
    D.fake_world(mesh.size)                   # this process is its rank 0
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert len(mesh._groups) == 0
    g = mesh.group("model")
    assert dist.get_process_group_ranks(g) == list(range(16)) and len(mesh._groups) == 1
    assert dist.get_process_group_ranks(mesh.group("data")) == list(range(0, 256, 16))
    if multi_pod:
        assert dist.get_world_size(mesh.group(("pod", "data"))) == 32
    assert mesh.group("model") is g and len(mesh._groups) == 2 + multi_pod


@pytest.mark.parametrize("strategy, axes", [("dp", {"data": 4, "model": 1}),
                                            ("fsdp_tp", {"data": 2, "model": 2})])
def test_recorder_counts_equal_comm_debug_mode(strategy, axes):
    """Every collective the traced step issues reaches the recorder: its
    count per kind is ``CommDebugMode``'s on the same trace."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = reduced(get_config("qwen2.5-3b"), **TINY)
    prog = input_specs(cfg, TINY_TRAIN, _mesh(axes),
                       TrainConfig(remat_policy="none"), strategy, device="cpu")
    with prog.fake_mode, CommDebugMode() as cdm, SH.record_collectives() as log:
        prog.fn(*prog.args)
    names = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather"}
    want = {names[str(k).split(".")[-1]]: v for k, v in cdm.get_comm_counts().items()}
    assert dict(collections.Counter(r.kind for r in log)) == want and want


def test_dp_flops_per_rank_are_a_quarter_at_four():
    one, _ = _trace("qwen2.5-3b", "train", {"data": 1, "model": 1}, "dp")
    four, _ = _trace("qwen2.5-3b", "train", {"data": 4, "model": 1}, "dp")
    assert four["xla_flops_per_module"] == pytest.approx(
        one["xla_flops_per_module"] / 4, rel=FLOPS_RTOL)
    assert four["collective_counts"] and not one["collective_counts"]


def test_run_cell_defaults_to_cuda():
    """Without ``device`` a cell traces on the card, and without one says so
    (before any world or trace is made)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would trace")
    with pytest.raises(RuntimeError, match="cuda"):
        D.run_cell("qwen2.5-3b", "train_4k", verbose=False)
    assert not dist.is_initialized()


def test_run_cell_skips_long_context_for_full_attention():
    row = D.run_cell("qwen2.5-3b", "long_500k", device="cpu", verbose=False)
    assert row["status"] == "SKIP" and "quadratic" in row["reason"]


def test_recorded_collectives_equal_a_gloo_run():
    """The collectives recorded on rank 0 of a traced tiny train step equal
    those rank 0 records when the same program runs over a CPU gloo pool of
    4 (kind, group size and bytes, in order), for dp and fsdp_tp."""
    cfg = reduced(get_config("qwen2.5-3b"), **TINY)
    tcfg = TrainConfig(remat_policy="none")
    cases = [("dp", {"data": 4, "model": 1}), ("fsdp_tp", {"data": 2, "model": 2})]
    traced = []
    for strategy, axes in cases:
        _, stats = _trace("qwen2.5-3b", "train", axes, strategy)
        traced.append([tuple(r) for r in stats.collectives])
    dist.destroy_process_group()
    with Pool(world=4, device="cpu") as pool:
        for (strategy, axes), want in zip(cases, traced):
            got = pool.run(jobs.recorded_collectives, cfg, tcfg, strategy,
                           TINY_TRAIN.global_batch, TINY_TRAIN.seq_len, mesh=axes)
            assert [tuple(r) for r in got[0]] == want and want, strategy


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def test_roofline_terms_equal_reference_at_its_rates():
    """With the reference's TPU rates passed in, the port's ``Roofline``
    gives the reference's terms; ``model_flops_for`` is the reference's for
    every cell; ``parse_collectives`` over records equals the reference's
    over the HLO lines that hold the same collectives."""
    from repro.configs import get_config as jax_get_config
    from repro.perf import roofline as JR
    from repro_torch.perf import roofline as R
    rates = dict(peak_flops=JR.PEAK_FLOPS, hbm_bw=JR.HBM_BW, link_bw=JR.LINK_BW)
    for args in ((63963136.0, 45857708.0, 3431592.0, 8, 327155712.0),
                 (377487360.0, 212700096.0, 0.0, 1, 327155712.0),
                 (1e15, 1e9, 1e12, 256, 0.0)):
        got = R.Roofline(*args[:4], model_flops=args[4]).finalize(**rates).to_dict()
        assert got == JR.Roofline(*args[:4], model_flops=args[4]).finalize().to_dict()
    for arch in ARCH_IDS:
        for s in ALL_SHAPES:
            assert R.model_flops_for(get_config(arch), s) == JR.model_flops_for(
                jax_get_config(arch), s)
    hlo = """
  %ar = f32[128,256]{1,0} all-reduce(f32[128,256] %x), replica_groups={{0,1}}
  %ag = bf16[64]{0} all-gather(bf16[32] %y), dimensions={0}
  %ar2 = bf16[8,4]{1,0} all-reduce(bf16[8,4] %z), replica_groups={{0,1}}
"""
    recs = [SH.CollectiveRecord("all-reduce", 2, 2.0 * 128 * 256 * 4),
            SH.CollectiveRecord("all-gather", 2, 64 * 2.0),
            SH.CollectiveRecord("all-reduce", 2, 2.0 * 8 * 4 * 2)]
    got, want = R.parse_collectives(recs), JR.parse_collectives(hlo)
    assert (got.counts, got.bytes_by_kind, got.total_per_chip_bytes, got.ops) == (
        want.counts, want.bytes_by_kind, want.total_per_chip_bytes, want.ops)

def test_cells_and_shapes_equal_reference(reference):
    for arch in ARCH_IDS:
        for s in ALL_SHAPES:
            got = list(cell_is_runnable(get_config(arch), get_shape(s.name)))
            assert got == reference["runnable"][f"{arch}/{s.name}"], (arch, s.name)
    import dataclasses
    assert {s.name: dataclasses.asdict(s) for s in ALL_SHAPES} == reference["shapes"]


@pytest.mark.parametrize("mesh", sorted(CONSTRAIN_MESHES))
def test_constraint_resolution_equals_reference(reference, mesh):
    axes = dict(zip(("pod", "data", "model")[-len(CONSTRAIN_MESHES[mesh]):],
                    CONSTRAIN_MESHES[mesh]))
    ent = lambda e: SH.BATCH if e == "B" else tuple(e) if isinstance(e, list) else e
    got = [SH.spec_to_json(SH.resolve_constraint(s, [ent(x) for x in e], axes))
           for s, e in CONSTRAIN_CASES]
    assert got == reference["constrain"][mesh]
    x = torch.zeros(8, 6, 4)
    assert SH.maybe_constrain(x, SH.BATCH, "model") is x


@pytest.mark.parametrize("mesh", sorted(CONSTRAIN_MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_shardings_equal_reference(reference, arch, mesh):
    """Each leaf's spec on the mesh, in the reference's stacked layout."""
    from repro_torch.models import model as MD
    from repro_torch.tree import reference_leaves, stack_dims, tree_leaves, tree_map
    axes = dict(zip(("pod", "data", "model")[-len(CONSTRAIN_MESHES[mesh]):],
                    CONSTRAIN_MESHES[mesh]))
    params = MD.param_shapes(reduced(get_config(arch)))
    shard = []
    tree_map(lambda p, s: shard.append(s), params, SH.param_shardings(params, axes,
                                                                      "fsdp_tp"))
    assert all(s.mesh is axes for s in shard)
    ax = []
    tree_map(lambda p, a: ax.append(a), params, MD.param_axes(params))
    leaves = tree_leaves(params)
    got = {}
    for path, idx in reference_leaves(params):
        spec = SH.spec_entries(shard[idx[0]].spec, leaves[idx[0]].ndim)
        if ax[idx[0]].transposed:
            spec = spec[::-1]
        lead = (None,) * len(stack_dims(params, path))
        key = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                      for k in ("kernel" if k == "weight" else k for k in path))
        got[key] = SH.spec_to_json(SH._trim(lead + tuple(spec)))
    assert got == reference["param_shardings"][f"{arch}/{mesh}"]


def test_tiny_qwen_flops_and_argument_bytes_equal_reference(reference):
    """One device: the dots within 1 % (here exactly: both count the same
    einsums and matmuls). 2 x 2 x 2: the rank's argument bytes (state slices,
    step count, batch rows) equal XLA's ``argument_size_in_bytes``. The
    reference's fused hbm bytes are printed beside the port's eager count,
    not gated."""
    ref1 = reference["rows"]["qwen_train_1x1x1"]
    ref8 = reference["rows"]["qwen_train_2x2x2"]
    one, _ = _trace("qwen2.5-3b", "train", MESHES["1x1x1"])
    eight, _ = _trace("qwen2.5-3b", "train", MESHES["2x2x2"])
    assert one["xla_flops_per_module"] == pytest.approx(ref1["roofline"]["flops"],
                                                        rel=FLOPS_RTOL)
    assert ref1["roofline"]["flops"] == 377487360
    for got, want in ((one, ref1), (eight, ref8)):
        assert (got["memory"]["argument_size_in_bytes"]
                == want["memory"]["argument_size_in_bytes"])
    print(f"hbm bytes 1x1x1: port {one['roofline']['hbm_bytes']:.0f} reference "
          f"{ref1['roofline']['hbm_bytes']:.0f}; 2x2x2: port "
          f"{eight['roofline']['hbm_bytes']:.0f} reference "
          f"{ref8['roofline']['hbm_bytes']:.0f}")
    assert eight["roofline"]["collective_bytes"] > 0


def test_custom_op_formulas_hold_serve_cells_to_reference(reference, monkeypatch):
    """With the model's attention and SSD scan going through the custom ops
    (their flop formulas), a one-device prefill's dots are the reference's:
    qwen within 1 %, mamba2 within the SSD formula's rank-one bound
    (``ssd_scan_rank1_bound``) times the SSD's share of the cell."""
    from repro_torch.perf.op_analysis import ssd_scan_flops, ssd_scan_rank1_bound
    _card_ops(monkeypatch)
    qwen, _ = _trace("qwen2.5-3b", "prefill", MESHES["1x1x1"])
    assert qwen["xla_flops_per_module"] == pytest.approx(
        reference["rows"]["qwen_prefill_1x1x1"]["roofline"]["flops"], rel=FLOPS_RTOL)
    cfg = reduced(get_config("mamba2-370m"), **TINY)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    ssd = cfg.n_layers * ssd_scan_flops((8, 64, d_in // s.head_dim, s.head_dim), None,
                                        None, (8, 64, s.n_groups, s.d_state), None,
                                        None, s.chunk_size)
    mamba, _ = _trace("mamba2-370m", "prefill", MESHES["1x1x1"])
    want = reference["rows"]["mamba2_prefill_1x1x1"]["roofline"]["flops"]
    tol = ssd_scan_rank1_bound(s.chunk_size, s.d_state, s.head_dim) * ssd / want
    assert abs(mamba["xla_flops_per_module"] / want - 1) <= tol, (
        mamba["xla_flops_per_module"], want, tol)
    plain, _ = _trace("mamba2-370m", "train", MESHES["1x1x1"])
    print(f"mamba2 train, plain SSD: port {plain['xla_flops_per_module']:.0f} "
          f"reference {reference['rows']['mamba2_train_1x1x1']['roofline']['flops']:.0f}")


def test_row_keys_equal_reference(reference, monkeypatch):
    """``run_cell``'s row, here of the tiny cell on a mesh of one, has the
    reference's keys, and those of its memory and roofline."""
    ref = reference["rows"]["qwen_train_1x1x1"]
    monkeypatch.setattr(D, "get_config", lambda a: reduced(get_config(a), **TINY))
    monkeypatch.setattr(D, "get_shape", lambda s: TINY_TRAIN)
    monkeypatch.setattr(D, "make_production_mesh", lambda multi_pod=False: SH.Mesh(
        MESHES["1x1x1"], 0, SH.LazyGroups()))
    row = D.run_cell("qwen2.5-3b", "tiny_train", remat="none", verbose=False,
                     device="cpu")
    assert row["status"] == "OK" and set(row) == set(ref)
    for k in ("memory", "roofline"):
        assert set(row[k]) == set(ref[k]), k
    assert row["compile_s"] == 0.0 and row["n_chips"] == 1
    assert row["xla_flops_per_module"] == ref["roofline"]["flops"]
