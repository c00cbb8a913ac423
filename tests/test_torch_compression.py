"""Port parity for the int8 wire codec and its tree plumbing: the plain
PyTorch versions of the CUDA codec kernels against the reference's eager jnp
codec (``repro.dist.compression``, which takes its jnp path on the CPU) and
against its Pallas kernels in interpret mode.

The contract is bit-identity: the same int8 values, the same fp32 scale bit
for bit, the same dequantized values and error-feedback residuals. Inputs
are drawn with numpy and handed to both packages; the reference is called
eagerly (no ``jit``), where its divide by 127 stays a divide.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.dist import compression as JC
from repro.kernels.quantize import dequantize_int8_pallas, quantize_int8_pallas
from repro.models import model as JMD
from repro.models.layers import pvalues
from repro_torch.configs import get_config, reduced
from repro_torch.dist import compression as C
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as Q
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import reference_leaves, tree_leaves

QUANT_SHAPES = [            # tests/test_kernels.py QUANT_SHAPES
    (5, 5, 3, 16),
    (400, 120),
    (84,),
    (257, 129),
    (8192,),
]
RANDOM_SIZES = [1, 2, 7, 31, 127, 128, 129, 300, 511, 600]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _assert_codec_equal(x_np, jdtype=jnp.float32, tdtype=torch.float32):
    """Port codec == eager reference == interpret-mode Pallas, bit for bit."""
    jx = jnp.asarray(x_np, jdtype)
    tx = torch.from_numpy(np.asarray(x_np, np.float32)).to(tdtype)
    np.testing.assert_array_equal(np.asarray(jx, np.float32), tx.float().numpy())
    jq, js = JC.quantize_int8(jx)
    pq, ps = quantize_int8_pallas(jx, interpret=True)
    tq, ts = C.quantize_int8(tx)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == x_np.shape
    assert ts.dtype == torch.float32 and ts.dim() == 0
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(tq), np.asarray(pq))
    assert _bits(_np(ts)) == _bits(js) == _bits(ps)
    jd = JC.dequantize_int8(jq, js)
    td = C.dequantize_int8(tq, ts)
    assert td.dtype == torch.float32
    np.testing.assert_array_equal(_bits(_np(td)), _bits(jd))
    np.testing.assert_array_equal(
        _bits(_np(td)), _bits(dequantize_int8_pallas(pq, ps, interpret=True)))
    return tq, ts


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_codec_matches_reference(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    tq, ts = _assert_codec_equal(x)
    # one-ulp round-trip bound of the codec
    err = np.abs(_np(C.dequantize_int8(tq, ts)) - x).max()
    assert err <= float(ts) / 2 + 1e-8


@pytest.mark.parametrize("i", range(20))
def test_codec_half_ulp_boundaries(i):
    """Every element sits at a (k + 0.5)·scale rounding boundary, where a
    multiply by 1/scale (or a reciprocal rewrite of the divide) would round
    the other way; built as tests/test_kernels.py builds them."""
    x = half_ulp_tensor(np.random.default_rng(1000 + i))
    _assert_codec_equal(x)


def half_ulp_tensor(rng) -> np.ndarray:
    mx = np.float32(rng.uniform(0.5, 5.0))
    scale = np.float32(mx / np.float32(127.0))
    k = rng.integers(-126, 126, 512).astype(np.float32)
    x = (k + np.float32(0.5)) * scale
    x[0] = mx
    return x.astype(np.float32)


def test_codec_zero_tensor():
    tq, ts = _assert_codec_equal(np.zeros((33,), np.float32))
    assert float(ts) == 0.0 and not tq.any()


@pytest.mark.parametrize("n", RANDOM_SIZES)
def test_codec_random_sizes(n):
    rng = np.random.default_rng(n)
    mag = 10.0 ** rng.uniform(-3, 3)
    _assert_codec_equal((rng.standard_normal(n) * mag).astype(np.float32))


def test_codec_bf16_input():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((96, 40)) * 2.0).astype(np.float32)
    _assert_codec_equal(x, jnp.bfloat16, torch.bfloat16)


def test_shared_scale_is_the_max_over_all_tensors():
    rng = np.random.default_rng(8)
    xs = [(rng.standard_normal((6, 10)) * m).astype(np.float32)
          for m in (0.1, 4.0, 0.5)]
    qs, s = ops.quantize_int8_shared([torch.from_numpy(x) for x in xs])
    jq, js = JC.quantize_int8(jnp.asarray(np.stack(xs)))
    assert _bits(_np(s)) == _bits(js)
    np.testing.assert_array_equal(np.stack([_np(q) for q in qs]), np.asarray(jq))


@pytest.mark.parametrize("mode", JC.COMPRESSIONS)
def test_compress_decompress_modes(mode):
    """Five steps with the residual threaded between them (int8_ef); the
    other modes pass ``err`` through untouched."""
    rng = np.random.default_rng(11)
    jerr, terr = None, None
    for step in range(5):
        g = (rng.standard_normal((37, 19)) * (1 + step)).astype(np.float32)
        jd, jerr = JC.compress_decompress(jnp.asarray(g), mode, jerr)
        td, terr = C.compress_decompress(torch.from_numpy(g), mode, terr)
        np.testing.assert_array_equal(_bits(_np(td)), _bits(jd))
        if mode == "int8_ef":
            np.testing.assert_array_equal(_bits(_np(terr)), _bits(jerr))
        else:
            assert terr is None and jerr is None


def test_compress_decompress_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown compression mode"):
        C.compress_decompress(torch.zeros(3), "int4")


# ---------------------------------------------------------------------------
# compress_tree: one scale per stacked reference leaf
# ---------------------------------------------------------------------------

LAYER_MAGNITUDES = (0.05, 3.0, 0.4)


def _grads_tree(seed=0):
    """A reduced smollm-360m grads tree in the reference's layout (per-layer
    leaves stacked [3, ...]), each layer of a stacked leaf at its own
    magnitude, so that a scale per layer gives other values than one scale
    per leaf; plus its conversion to the port's layout."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("smollm-360m")),
                               n_layers=len(LAYER_MAGNITUDES))
    cfg = dataclasses.replace(reduced(get_config("smollm-360m")),
                              n_layers=len(LAYER_MAGNITUDES))
    skel = jax.tree.map(np.asarray, pvalues(JMD.init_model(jax.random.PRNGKey(0),
                                                           jcfg)))
    rng = np.random.default_rng(seed)

    def draw(a):
        g = rng.standard_normal(a.shape).astype(np.float32)
        return g

    tree = jax.tree.map(draw, skel)
    mags = np.asarray(LAYER_MAGNITUDES, np.float32)
    tree["segments"][0] = jax.tree.map(
        lambda g: g * mags.reshape((-1,) + (1,) * (g.ndim - 1)),
        tree["segments"][0])
    return tree, cfg


def _assert_tree_bits_equal(port_tree, ref_tree, cfg):
    conv = params_from_jax(jax.tree.map(np.asarray, ref_tree), cfg, device="cpu")
    a, b = tree_leaves(port_tree), tree_leaves(conv)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(_np(x)), _bits(_np(y)))


@pytest.mark.parametrize("mode", ["int8", "int8_ef"])
def test_compress_tree_matches_reference(mode):
    ref_tree, cfg = _grads_tree()
    port_tree = params_from_jax(ref_tree, cfg, device="cpu")
    jgrads = jax.tree.map(jnp.asarray, ref_tree)
    jef, tef = None, None
    for step in range(3):
        jd, jef = JC.compress_tree(jgrads, mode, jef)
        td, tef = C.compress_tree(port_tree, mode, tef)
        _assert_tree_bits_equal(td, jd, cfg)
        if mode == "int8_ef":
            _assert_tree_bits_equal(tef, jef, cfg)
        else:
            assert tef is None and jef is None


def test_compress_tree_shares_one_scale_per_stacked_leaf():
    """11 reference leaves for smollm (embed, final_norm, 9 stacked), and a
    scale per port tensor would not reproduce the reference."""
    ref_tree, cfg = _grads_tree()
    port_tree = params_from_jax(ref_tree, cfg, device="cpu")
    groups = reference_leaves(port_tree)
    assert len(groups) == 11
    assert sorted(len(idx) for _, idx in groups) == [1, 1] + [3] * 9
    td, _ = C.compress_tree(port_tree, "int8")
    leaves, got = tree_leaves(port_tree), tree_leaves(td)
    (_, wq), = [(p, idx) for p, idx in groups if p[-2:] == ("wq", "weight")]
    # the small-magnitude layer on the shared grid vs on its own grid
    own = ops.dequantize_int8(*ops.quantize_int8(leaves[wq[0]]))
    assert not torch.equal(own, got[wq[0]])
    jd, _ = JC.compress_tree(jax.tree.map(jnp.asarray, ref_tree), "int8")
    ref_wq = np.asarray(jd["segments"][0]["attn"]["wq"]["kernel"])[0]
    np.testing.assert_array_equal(_np(got[wq[0]]), ref_wq.T)


def test_compress_tree_none_passes_through():
    t = {"a": torch.ones(2)}
    assert C.compress_tree(t, "none") == (t, None)


def test_compress_tree_int8_ef_initialises_residuals():
    ref_tree, cfg = _grads_tree(seed=3)
    port_tree = params_from_jax(ref_tree, cfg, device="cpu")
    _, tef = C.compress_tree(port_tree, "int8_ef")
    assert tef is not None
    for e, g in zip(tree_leaves(tef), tree_leaves(port_tree)):
        assert e.dtype == torch.float32 and e.shape == g.shape


def test_plain_codec_functions_compose():
    """quantize_int8 is absmax then quantize on that max-abs."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(300)
                         .astype(np.float32))
    q, s = Q.quantize_plain(x, Q.absmax_plain(x))
    q2, s2 = ops.quantize_int8(x)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert float(Q.absmax_plain(x)) == float(x.abs().max())
