"""Port parity: the compressed collectives and the Megatron f/g pair over a
world of CPU ranks (``repro_torch.dist``) against ``repro.dist.compression``
under ``shard_map``.

The reference runs in one subprocess on an 8-device host pool, under a
``Mesh`` of Auto axes, and writes its results to a temporary .npz. Its
int8 and int8_ef ``shard_map`` runs un-jitted, op by op, as the codec's
contract is stated (jitted, XLA fuses ``carried − q·scale`` into one
rounding); none and bf16 run jitted. The port runs on one gloo ``Pool`` of 8
CPU ranks for the module. Both get the same per-rank inputs, drawn from seeds
with numpy. int8 and the error-feedback residuals are held bit for bit (the
grid is agreed by a MAX all-reduce and the integer sums are exact); none
and bf16 within n·2⁻²³·max|x|, since the float sums run in another order.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_pool_jobs as jobs
from repro_torch.dist import probes
from repro_torch.dist.compression import (compressed_psum_mean,
                                          compressed_psum_mean_ef)
from repro_torch.dist.pool import Pool

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
WORLDS = (2, 4, 8)
MODES = ("none", "bf16", "int8", "int8_ef")
SHAPES = ((24, 20), (5, 5, 3, 4), (7,))
EF_STEPS = 3
EF_SHAPES = SHAPES[:2]      # op-by-op shard_map costs ~1.5 s a step here

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.compression import compressed_psum_mean, compressed_psum_mean_ef

inputs = np.load(sys.argv[1])
out = {}
for key in inputs.files:
    xs = inputs[key]                               # [steps, n, ...]
    mode, n = key.split("/")[0], xs.shape[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    if mode == "int8_ef":
        def body(x, e):
            m, ne = compressed_psum_mean_ef(x[0], "data", e[0])
            return m[None], ne[None]
        f = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")), check_rep=False)
        err = np.zeros(xs.shape[1:], np.float32)
        means, residuals = [], []
        for x in xs:
            m, err = f(x, err)
            means.append(np.asarray(m))
            residuals.append(np.asarray(err))
            err = np.asarray(err)
        out[key + "/means"] = np.stack(means)
        out[key + "/residuals"] = np.stack(residuals)
    else:
        f = shard_map(lambda x: compressed_psum_mean(x[0], "data", mode)[None],
                      mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                      check_rep=False)
        if mode != "int8":
            f = jax.jit(f)
        out[key + "/means"] = np.stack([np.asarray(f(x)) for x in xs])
np.savez(sys.argv[2], **out)
print("ok")
"""


def _inputs():
    """{"mode/n/j": [steps, n, *shape]} fp32, every rank at its own scale."""
    out = {}
    for n in WORLDS:
        for mode in MODES:
            steps = EF_STEPS if mode == "int8_ef" else 1
            for j, shape in enumerate(EF_SHAPES if mode == "int8_ef" else SHAPES):
                rng = np.random.default_rng(100 * n + 10 * j + MODES.index(mode))
                scale = rng.uniform(1e-3, 10.0, size=(steps, n) + (1,) * len(shape))
                out[f"{mode}/{n}/{j}"] = (rng.standard_normal((steps, n, *shape))
                                          * scale).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference_run(inputs, tmp_path_factory):
    """The reference's subprocess, started before the pool so the two
    overlap: (process, path of its results)."""
    tmp = tmp_path_factory.mktemp("collectives")
    src, dst = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(src, **inputs)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(src), str(dst)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(reference_run):
    with Pool(world=8, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def reference(reference_run, pool):
    proc, dst = reference_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def _port(pool, inputs, key):
    mode, n = key.split("/")[0], int(key.split("/")[1])
    return pool.run(probes.collective, inputs[key], mode, mesh={"data": n})


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compressed_psum_mean_matches_reference(pool, inputs, reference, mode, n):
    for j in range(len(SHAPES)):
        key = f"{mode}/{n}/{j}"
        want = reference[key + "/means"][0]            # [n, ...], one per rank
        tol = n * 2.0 ** -23 * float(np.abs(inputs[key]).max())
        for r, out in enumerate(_port(pool, inputs, key)):
            got = out["means"][0]
            assert got.shape == want[r].shape and got.dtype == np.float32
            if mode == "int8":
                np.testing.assert_array_equal(got, want[r])
            else:
                np.testing.assert_allclose(got, want[r], rtol=0, atol=tol)
            assert out["launches"]["quantize_absmax"] == 0     # plain on the CPU


@pytest.mark.parametrize("n", WORLDS)
def test_error_feedback_matches_reference_bit_for_bit(pool, inputs, reference, n):
    for j in range(len(EF_SHAPES)):
        key = f"int8_ef/{n}/{j}"
        means = reference[key + "/means"]              # [steps, n, ...]
        residuals = reference[key + "/residuals"]
        for r, out in enumerate(_port(pool, inputs, key)):
            np.testing.assert_array_equal(out["means"], means[:, r])
            np.testing.assert_array_equal(out["residuals"], residuals[:, r])
            assert out["launches"]["quantize_absmax"] == 0     # plain on the CPU
        assert np.abs(residuals).max() > 0


def test_int8_ef_and_unknown_modes_raise():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="compressed_psum_mean_ef"):
        compressed_psum_mean(x, None, "int8_ef")
    with pytest.raises(ValueError, match="unknown compression mode"):
        compressed_psum_mean(x, None, "fp8")
    mean, err = compressed_psum_mean_ef(x, None, torch.zeros(4))
    assert torch.equal(mean, x) and torch.equal(err, torch.zeros(4))


@pytest.mark.parametrize("m", [2, 4])
def test_tp_pair_grads_equal_unsplit(pool, m):
    """tp_f/tp_g around a row/column-split MLP give each model rank the
    unsplit grads of its slice and the whole input grad — not m times it,
    which a differentiable all-reduce in place of tp_g would give."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    w1 = (rng.standard_normal((8, 10)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((5, 8)) * 0.3).astype(np.float32)
    full = torch.func.grad_and_value(jobs.split_mlp_loss, argnums=(0, 1, 2))(
        *(torch.from_numpy(a) for a in (x, w1, w2)))
    (gx, gw1, gw2), loss = [g.numpy() for g in full[0]], float(full[1])
    res = pool.run(jobs.split_mlp_grads, x, w1, w2, mesh={"model": m})
    for r, (rx, rw1, rw2, rloss) in enumerate(res):
        rows = slice(r * 8 // m, (r + 1) * 8 // m)
        np.testing.assert_allclose(rx, gx, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rw1, gw1[rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rw2, gw2[:, rows], rtol=1e-5, atol=1e-6)
        assert rloss == pytest.approx(loss, rel=1e-6)
        assert not np.allclose(rx, m * gx, rtol=1e-3)
