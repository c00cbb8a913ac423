"""Port parity: LeNet-5 (the paper's subject) against ``repro.models.lenet``.

Weights are numpy draws from a seed at ``init_lenet``'s shapes and scales,
held by the reference as its ``Param`` tree and converted to the port's
layout (``lenet_params_from_jax``); one test converts ``init_lenet``'s own
draws. The batch is the same numpy draw in both layouts. Dropout is 0 (the two packages' random bits differ). The
reference runs jitted, as its sweep runs it; the port runs on the CPU in
eager mode. Tolerance for logits, loss, grads and new parameters: atol
1e-5, rtol 1e-4 (fp32; convolutions and matmuls sum in different orders in
XLA and in PyTorch).
"""
import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs.lenet5 import LeNet5Config as JaxCfg
from repro.data.synthetic import lenet_batch as jax_lenet_batch
from repro.models import lenet as JL
from repro.models.layers import Param
from repro.perf.sweep import make_iteration as jax_make_iteration
from repro_torch.configs.lenet5 import (DATASETS, KERNEL_SIZES, LeNet5Config,
                                        PADDING_MODES, POOL_SIZES, STRIDES)
from repro_torch.data import image_batch, lenet_batch
from repro_torch.models import lenet as TL
from repro_torch.models.convert import lenet_params_from_jax
from repro_torch.perf.sweep import _adam_step, make_iteration

ATOL, RTOL = 1e-5, 1e-4
jax_init = jax.jit(JL.init_lenet, static_argnums=(1,))
jax_loss_grad = jax.jit(jax.value_and_grad(JL.lenet_loss), static_argnums=(2,))


@functools.partial(jax.jit, static_argnums=(2,))
def jax_logits_loss_grads(params, batch, cfg):
    return (JL.lenet_forward(params, batch["images"], cfg),
            *jax.value_and_grad(JL.lenet_loss)(params, batch, cfg, None))

# Corners of Table 1, the degenerate ones included: maps smaller than the
# kernel (valid falls back to same) or than the pool window, even kernels
# (asymmetric same padding), stride 3 with same, cifar10's 3 channels.
CORNERS = [
    dict(kernel_size=5, pool_size=2, padding="valid", stride=1, dataset="mnist",
         activation="relu", optimizer="sgd", n_filters=4, learning_rate=0.1),
    dict(kernel_size=5, pool_size=5, padding="same", stride=3, dataset="cifar10",
         activation="tanh", optimizer="adam", n_filters=8, learning_rate=0.01),
    dict(kernel_size=4, pool_size=2, padding="same", stride=2, dataset="mnist",
         activation="sigmoid", optimizer="sgd", n_filters=4, learning_rate=0.001),
    dict(kernel_size=5, pool_size=4, padding="valid", stride=1,
         dataset="fashion_mnist", activation="relu", optimizer="adam",
         n_filters=8, learning_rate=1e-4),
    dict(kernel_size=5, pool_size=5, padding="valid", stride=3, dataset="mnist",
         activation="tanh", optimizer="sgd", n_filters=4, learning_rate=0.1),
    dict(kernel_size=3, pool_size=3, padding="same", stride=2, dataset="cifar10",
         activation="sigmoid", optimizer="adam", n_filters=4, learning_rate=1e-5),
    dict(kernel_size=2, pool_size=2, padding="valid", stride=1, dataset="mnist",
         activation="relu", optimizer="sgd", n_filters=16, learning_rate=0.01),
    dict(kernel_size=2, pool_size=5, padding="same", stride=3, dataset="cifar10",
         activation="relu", optimizer="adam", n_filters=4, learning_rate=0.1),
    dict(kernel_size=4, pool_size=3, padding="valid", stride=2,
         dataset="fashion_mnist", activation="sigmoid", optimizer="sgd",
         n_filters=8, learning_rate=1e-6),
    dict(kernel_size=3, pool_size=4, padding="valid", stride=3, dataset="cifar10",
         activation="tanh", optimizer="adam", n_filters=4, learning_rate=0.001),
    dict(kernel_size=5, pool_size=3, padding="same", stride=1, dataset="cifar10",
         activation="relu", optimizer="sgd", n_filters=4, learning_rate=0.01),
    dict(kernel_size=4, pool_size=4, padding="same", stride=3, dataset="mnist",
         activation="tanh", optimizer="adam", n_filters=8, learning_rate=0.1),
]
IDS = [f"k{c['kernel_size']}p{c['pool_size']}s{c['stride']}{c['padding']}-"
       f"{c['dataset']}-{c['activation']}-{c['optimizer']}" for c in CORNERS]


def _cfgs(corner, batch=4):
    cfg = LeNet5Config(**corner, dropout=0.0, batch_size=batch)
    return cfg, JaxCfg(**dataclasses.asdict(cfg))


def _numpy_params(jcfg, seed):
    """The reference's Param tree with numpy N(0, 1/fan_in) values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(JL.init_lenet, cfg=jcfg),
                            jax.random.PRNGKey(0))
    out = {}
    for k, p in shapes.items():
        shape = p.value.shape
        scale = 1.0 / np.prod(shape[:-1]) ** 0.5
        out[k] = Param((rng.normal(size=shape) * scale).astype(np.float32),
                       p.axes)
    return out


def _setup(corner, seed=0):
    cfg, jcfg = _cfgs(corner)
    jparams = _numpy_params(jcfg, seed)
    jbatch = jax_lenet_batch(jcfg, step=0, seed=seed)
    params = lenet_params_from_jax(jparams, cfg, device="cpu")
    batch = lenet_batch(cfg, step=0, seed=seed, device="cpu")
    return cfg, jcfg, jparams, jbatch, params, batch


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _to_port(tree, cfg):
    return lenet_params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("dataset", DATASETS)
def test_feature_dims_equal_over_table1(dataset):
    """All kernel × pool × stride × padding corners of one dataset (96;
    288 over the three datasets), pure Python on both sides."""
    for k, p, s, pad in itertools.product(KERNEL_SIZES, POOL_SIZES, STRIDES,
                                          PADDING_MODES):
        cfg = LeNet5Config(kernel_size=k, pool_size=p, stride=s, padding=pad,
                           dataset=dataset)
        assert TL.feature_dims(cfg) == JL.feature_dims(
            JaxCfg(**dataclasses.asdict(cfg))), cfg


@pytest.mark.parametrize("corner", CORNERS, ids=IDS)
def test_logits_loss_grads_match_reference(corner):
    cfg, jcfg, jparams, jbatch, params, batch = _setup(corner)
    jlogits, jloss, jgrads = jax_logits_loss_grads(jparams, jbatch, jcfg)
    _close(TL.lenet_forward(params, batch["images"], cfg), jlogits, "logits")
    grads, loss = torch.func.grad_and_value(TL.lenet_loss)(params, batch, cfg,
                                                           None)
    _close(loss, jloss, "loss")
    want = _to_port(jgrads, cfg)
    assert set(grads) == set(want)
    for k in want:
        _close(grads[k], want[k], f"grad {k}")


def test_converted_init_lenet_matches_reference():
    """``init_lenet``'s own draws (``Param`` leaves) through the converter."""
    cfg, jcfg = _cfgs(CORNERS[2])
    jparams = jax_init(jax.random.PRNGKey(5), jcfg)
    params = lenet_params_from_jax(jparams, cfg, device="cpu")
    jbatch = jax_lenet_batch(jcfg, step=1, seed=5)
    batch = lenet_batch(cfg, step=1, seed=5)
    jlogits, jloss, jgrads = jax_logits_loss_grads(jparams, jbatch, jcfg)
    _close(TL.lenet_forward(params, batch["images"], cfg), jlogits, "logits")
    _close(TL.lenet_loss(params, batch, cfg, None), jloss, "loss")


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_iteration_matches_reference(optimizer):
    """One iteration: new params and loss vs the reference's.

    Adam's first step moves a weight by lr·g/(|g| + 1e-8), so where |g| is
    within a few decades of 1e-8 the fp32 rounding of g (2.5 % of a
    1.4e-7 gradient at this corner) moves the update by more than the
    tolerance. So for adam the port's full iteration is held to the
    tolerance where the reference's |g| ≥ 1e-6 (there the update's
    sensitivity to g is below 1 %) or g = 0 (kernel taps that only ever
    see padding), and the port's Adam step is held to the reference's new
    params everywhere from the reference's own grads.
    """
    corner = dict(CORNERS[1], optimizer=optimizer, learning_rate=0.01)
    cfg, jcfg, jparams, jbatch, params, batch = _setup(corner, seed=3)
    jnew, jloss = jax_make_iteration(jcfg, "jit")(
        jparams, jbatch, jax.random.PRNGKey(3))
    new, loss = make_iteration(cfg, "eager")(params, batch, None)
    _close(loss, jloss, "loss")
    want = _to_port(jnew, cfg)
    jgrads = _to_port(jax_loss_grad(jparams, jbatch, jcfg, None)[1], cfg)
    for k in want:
        assert not torch.equal(new[k], params[k]), k     # it moved
        if optimizer == "sgd":
            _close(new[k], want[k], f"new {k}")
            continue
        sure = (jgrads[k].abs() >= 1e-6) | (jgrads[k] == 0)
        assert sure.float().mean() > 0.9, k
        _close(new[k][sure], want[k][sure], f"new {k} where |g| >= 1e-6 or 0")
    if optimizer == "adam":
        zeros = {k: torch.zeros_like(g) for k, g in jgrads.items()}
        stepped, _, _ = _adam_step(params, jgrads, zeros, zeros,
                                   cfg.learning_rate, 1)
        for k in want:
            _close(stepped[k], want[k], f"adam step {k} from the same grads")


@pytest.mark.parametrize("dataset,batch,step,seed",
                         [("mnist", 8, 0, 0), ("cifar10", 5, 3, 11),
                          ("fashion_mnist", 1, 2 ** 20, 7)])
def test_lenet_batch_bit_equal(dataset, batch, step, seed):
    cfg, jcfg = _cfgs(dict(CORNERS[0], dataset=dataset), batch=batch)
    ref = jax_lenet_batch(jcfg, step=step, seed=seed)
    got = lenet_batch(cfg, step=step, seed=seed)
    nhwc = got["images"].permute(0, 2, 3, 1).numpy()
    assert nhwc.dtype == np.float32
    np.testing.assert_array_equal(nhwc, np.asarray(ref["images"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    images, labels = image_batch(cfg.image_shape, batch, step, seed)
    np.testing.assert_array_equal(images, np.asarray(ref["images"]))


@pytest.mark.parametrize("corner", CORNERS[:3], ids=IDS[:3])
def test_init_matches_reference_shapes_and_scales(corner):
    """The port's own init: the reference's shapes in the port's layout,
    the reference's fan-in scales (checked on the sample std)."""
    cfg, jcfg = _cfgs(dict(corner, n_filters=32))
    shapes = jax.eval_shape(functools.partial(JL.init_lenet, cfg=jcfg),
                            jax.random.PRNGKey(0))
    want = _to_port({k: np.zeros(p.value.shape, np.float32)
                     for k, p in shapes.items()}, cfg)
    got = TL.init_lenet(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k in got:
        assert got[k].dtype == torch.float32
        fan_in = got[k][0].numel()
        assert abs(got[k].std().item() * fan_in ** 0.5 - 1) < 0.2, k
    again = TL.init_lenet(cfg, seed=0, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_dropout_keeps_by_the_noise():
    """Units whose draw is below 1 - p are kept and scaled by 1/(1 - p),
    the others zeroed, as the reference's mask does with its key."""
    cfg, _ = _cfgs(CORNERS[0])
    cfg = dataclasses.replace(cfg, dropout=0.5)
    params = TL.init_lenet(cfg, seed=0, device="cpu")
    batch = lenet_batch(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    noise = TL.dropout_noise(gen, cfg.batch_size)
    assert tuple(noise.shape) == (cfg.batch_size, TL.HIDDEN[0])
    base = TL.lenet_forward(params, batch["images"], cfg)
    kept = TL.lenet_forward(params, batch["images"], cfg, train=True,
                            rng=torch.zeros_like(noise))
    dropped = TL.lenet_forward(params, batch["images"], cfg, train=True,
                               rng=torch.ones_like(noise))
    assert not torch.allclose(kept, base)         # scaled by 1 / (1 - p)
    assert torch.equal(dropped, torch.zeros_like(dropped))   # relu(0) = 0
