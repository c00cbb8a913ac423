"""Port parity: the sharded train step's legacy body
(``repro_torch.train.step.make_sharded_train_step``) and the logical-rule
resolution (``repro_torch.dist.sharding.param_pspecs``) against
``repro.train.step`` and ``repro.dist.sharding``.

Specs are compared in-process on the reference's layout (stacked layers,
``[d_in, d_out]`` kernels) for every arch of ``ARCH_IDS`` (reduced), every
strategy and three meshes. The step runs the cases of
``tests/test_sharded_step.py`` (reduced smollm, mesh (4, 2), the sgd trick:
sgd with b1 = 0, no decay, no clip, so (p0 − p1)/lr is the reduced mean
gradient) plus a reduced mamba2 case, on one gloo ``Pool`` of 8 CPU ranks
for the module, from the reference's init converted to the port. The
reference's full-batch gradients and per-data-shard gradient maxima come
from one subprocess on an 8-device host pool, started before the pool.
Tolerances are the reference test's tiers, per reference leaf: none
1e-5 + 1e-5·max|g|; bf16 1e-5 + shard_max/256; int8 and int8_ef
1e-5 + 0.75·shard_max/127; the int8_ef residual engaged and at most
0.51·shard_max/127 + 1e-7.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.dist import sharding as JSH
from repro.models import model as JMD
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist import sharding as SH
from repro_torch.dist.pool import Pool
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import reference_leaves, stack_dims, tree_leaves, tree_map

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_pool_jobs as jobs  # noqa: E402

WORLD = 8
MESH = {"data": 4, "model": 2}
LR = 1e-2
# (arch, reduced(...) overrides, batch, seq, data shards of the maxima)
SMOLLM = ("smollm-360m", dict(n_layers=1, d_model=32, vocab=128, d_ff=64), 8, 16, 4)
MAMBA = ("mamba2-370m", {}, 8, 32, 4)
# The sgd trick reads g back at a precision of ulp(|p|)/lr: mamba2's dt_bias
# (about -6.9) at lr 1e-2 gives 2.4e-5, above the tier's floor, so its case
# steps at lr 1 (1e-2 leaves the reduced smollm's leaves, |p| <= 1, at 6e-6).
MAMBA_LR = 1.0
CASES = ([(s, "none") for s in ("dp", "fsdp", "tp", "fsdp_tp")]
         + [(s, "int8") for s in ("dp", "fsdp", "tp", "fsdp_tp")]
         + [("dp", "bf16"), ("fsdp_tp", "int8_ef")])

# Writes, per model, the reference's fp32 init, the global batch, the
# full-batch gradient, and per leaf its largest |g| over the DATA shards'
# gradients and over the full batch's, each broadcast to the leaf's shape
# (so the port's converter maps them onto its tensors).
REFERENCE = r"""
import os, sys, json, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_config, reduced
from repro.data import make_batch_for
from repro.models import model as MD
from repro.models.layers import pvalues

out = {}
for arch, red, B, S, data in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(reduced(get_config(arch), **red), dtype="float32",
                              param_dtype="float32")
    batch = make_batch_for(cfg, B, S, step=0)
    params = MD.init_model(jax.random.PRNGKey(0), cfg)
    grad_of = jax.jit(jax.value_and_grad(lambda p, b: MD.loss_fn(p, cfg, b),
                                         has_aux=True))
    (_, _), g = grad_of(params, batch)
    g = jax.tree.map(lambda x: np.asarray(x, np.float32), pvalues(g))
    smax = jax.tree.map(lambda x: np.zeros_like(x), g)
    for i in range(data):
        sub = jax.tree.map(lambda x: x[i * (B // data):(i + 1) * (B // data)],
                           batch)
        (_, _), gs = grad_of(params, sub)
        smax = jax.tree.map(lambda m, x: np.maximum(m, np.abs(np.asarray(
            x, np.float32)).max()), smax, pvalues(gs))
    out[arch] = {"params": jax.tree.map(np.asarray, pvalues(params)),
                 "batch": {k: np.asarray(v) for k, v in batch.items()},
                 "grads": g, "shard_max": smax,
                 "gmax": jax.tree.map(lambda x: np.full_like(x, np.abs(x).max()), g)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("ok")
"""


def _cfg(arch, red):
    return dataclasses.replace(reduced(get_config(arch), **red), dtype="float32",
                               param_dtype="float32")


def _tcfg(comp, lr=LR):
    return TrainConfig(learning_rate=lr, optimizer="sgd", beta1=0.0,
                       weight_decay=0.0, grad_clip=1e9, total_steps=10,
                       warmup_steps=0, remat_policy="none", grad_compression=comp)


def start_reference(tmp_path_factory, models):
    """The reference's subprocess for ``models`` (entries as SMOLLM),
    started at once: (process, path of its results)."""
    import json
    dst = tmp_path_factory.mktemp("sharded_step") / "reference.pkl"
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(models),
                             str(dst)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    return proc, dst


def read_reference(proc, dst):
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    proc, dst = start_reference(tmp_path_factory, [SMOLLM, MAMBA])
    yield proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(reference_run):
    with Pool(world=WORLD, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def reference(reference_run, pool):
    return read_reference(*reference_run)


def port_tree(ref, key, cfg):
    """A reference tree (numpy, stacked) as the port's tensors, in
    ``tree_leaves`` order."""
    return [t.numpy() for t in tree_leaves(params_from_jax(ref[key], cfg,
                                                           device="cpu"))]


def tolerance(mode, smax, gmax, floor=1e-5):
    """The reference test's tier for one tensor (its leaf's maxima)."""
    s8 = smax / 127.0
    return {"none": floor + 1e-5 * gmax, "bf16": floor + smax / 256.0,
            "int8": floor + 0.75 * s8, "int8_ef": floor + 0.75 * s8}[mode]


def check_grads(res, ref, cfg, mode, floor=1e-5):
    """(p0 − p1)/lr of the port's gathered new params against the
    reference's full-batch gradient, per tensor within its leaf's tier;
    returns the worst error as a share of its tolerance."""
    p0 = port_tree(ref, "params", cfg)
    want = port_tree(ref, "grads", cfg)
    smax = port_tree(ref, "shard_max", cfg)
    gmax = port_tree(ref, "gmax", cfg)
    worst = 0.0
    for j, (a, b) in enumerate(zip(p0, res["params"])):
        got = (a - b) / res["lr"]
        err = float(np.abs(got - want[j]).max())
        lim = tolerance(mode, float(smax[j].max()), float(gmax[j].max()), floor)
        assert err <= lim, (mode, j, err, lim)
        worst = max(worst, err / lim)
    return worst


def check_residuals(ranks, ref, cfg):
    """int8_ef: some residual is non-zero and each is within 0.51 of its
    leaf's shard-max ulp."""
    smax = port_tree(ref, "shard_max", cfg)
    total = 0.0
    for out in ranks:
        for j, e in enumerate(out["ef"]):
            total += float(np.abs(e).sum())
            assert float(np.abs(e).max()) <= float(smax[j].max()) / 127.0 * 0.51 + 1e-7
    assert total > 0, "error feedback never engaged"


@pytest.mark.parametrize("strategy,comp", CASES)
def test_legacy_body_matches_full_batch_grads(pool, reference, strategy, comp):
    arch, red = SMOLLM[:2]
    cfg, ref = _cfg(arch, red), reference[arch]
    res = pool.run(jobs.sharded_step, cfg, _tcfg(comp), strategy, [False],
                   ref["params"], ref["batch"], mesh=MESH)
    ranks = [r[False] for r in res]
    assert len({r["loss"] for r in ranks}) == 1      # pmean: one loss
    check_grads(ranks[0], ref, cfg, comp)
    if comp == "int8_ef":
        check_residuals(ranks, ref, cfg)


def test_legacy_body_mamba2_runs_the_ssd_plain_version(pool, reference):
    """Reduced mamba2 (the SSD scan's plain version on every rank) under
    fsdp_tp with int8_ef."""
    arch, red = MAMBA[:2]
    cfg, ref = _cfg(arch, red), reference[arch]
    res = pool.run(jobs.sharded_step, cfg, _tcfg("int8_ef", MAMBA_LR), "fsdp_tp", [False],
                   ref["params"], ref["batch"], mesh=MESH)
    ranks = [r[False] for r in res]
    check_grads(ranks[0], ref, cfg, "int8_ef")
    check_residuals(ranks, ref, cfg)


# ---------------------------------------------------------------------------
# Logical-rule resolution against the reference's, every arch
# ---------------------------------------------------------------------------

_SPEC_MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4},
                {"data": 8, "model": 1}]


def _keystr(path):
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


_SKELETONS = {}


def _skeletons(arch):
    """(reference eval_shape tree, port params) at reduced size, cached."""
    if arch not in _SKELETONS:
        jcfg = jax_reduced(jax_get_config(arch))
        shapes = jax.eval_shape(lambda: JMD.init_model(jax.random.PRNGKey(0), jcfg))
        port = MD.init_model(reduced(get_config(arch)), device="cpu")
        _SKELETONS[arch] = (shapes, port)
    return _SKELETONS[arch]


def _reference_specs(shapes, mesh, strategy):
    tree = JSH.param_pspecs(shapes, mesh, strategy)
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(path): JSH.spec_to_json(spec)
            for path, spec in leaves}


def _flat(params, tree):
    """``tree``'s entries at ``params``' tensors, in ``tree_leaves`` order
    (its leaves are tuples, which ``tree_leaves`` would open)."""
    out = []
    tree_map(lambda p, x: out.append(x), params, tree)
    return out


def _port_specs(params, mesh, strategy):
    """The port's specs in the reference's layout, by reference leaf: every
    layer of a leaf must resolve alike."""
    leaves = tree_leaves(params)
    axes = _flat(params, MD.param_axes(params))
    port = _flat(params, SH.param_pspecs(params, mesh, strategy))
    out = {}
    for path, idx in reference_leaves(params):
        got = {port[i] for i in idx}
        assert len(got) == 1, (path, got)
        spec = SH.spec_entries(port[idx[0]], leaves[idx[0]].ndim)
        if axes[idx[0]].transposed:
            spec = spec[::-1]
        lead = (None,) * len(stack_dims(params, path))
        key = tuple("kernel" if k == "weight" else k for k in path)
        out[_keystr(key)] = SH.spec_to_json(SH._trim(lead + tuple(spec)))
    return out


@pytest.mark.parametrize("mesh", _SPEC_MESHES, ids=lambda m: f"{m['data']}x{m['model']}")
@pytest.mark.parametrize("strategy", sorted(SH.STRATEGIES))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_param_pspecs_match_reference(arch, strategy, mesh):
    shapes, port = _skeletons(arch)
    assert _port_specs(port, mesh, strategy) == _reference_specs(shapes, mesh,
                                                                 strategy)


def test_batch_shardings_take_this_ranks_rows():
    """Rows of each rank under (data 4, model 2): data index d holds rows
    [2d, 2d + 2) of 8, whatever its model index; an indivisible leading dim
    stays whole, as ``batch_pspec`` leaves it."""
    import torch
    from repro_torch.launch.specs import batch_shardings
    x = torch.arange(8 * 3).reshape(8, 3)
    odd = torch.arange(5)
    for rank in range(8):
        mesh = SH.Mesh(MESH, rank, {})
        got = batch_shardings({"tokens": x, "odd": odd}, mesh)
        d = mesh.index("data")
        assert torch.equal(got["tokens"], x[2 * d:2 * d + 2])
        assert torch.equal(got["odd"], odd)
    assert SH.batch_pspec(MESH, 2, 8) == ("data", None)
    assert SH.batch_pspec({"pod": 2, "data": 2, "model": 2}, 1, 8) == (("pod", "data"),)


def test_plan_remesh_matches_reference():
    from repro.train.ft import plan_remesh as jax_plan_remesh
    from repro_torch.launch.mesh import plan_remesh
    for n in range(1, 17):
        want, got = jax_plan_remesh(n), plan_remesh(n)
        assert (got.mesh_shape, got.axis_names, got.reason) == (
            tuple(want.mesh_shape), tuple(want.axis_names), want.reason)
    assert plan_remesh(4).mesh_shape == (2, 2)
    assert plan_remesh(8).mesh_shape == (2, 4)
