"""Port parity for the optimizers, gradient clipping and the learning-rate
schedule, against ``repro.optim`` on the same fp32 parameters and grads.

Parameters come from the reference's ``init_model`` (reduced smollm-360m,
fp32), grads are numpy draws of the same structure; both are converted to
the port's layout with ``params_from_jax``. Three updates are applied, each
with its own grads and the schedule's learning rate, and params and
optimizer state are compared within 1e-6 (fp32 sums in another order;
adafactor's means and square roots included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMD
from repro.models.layers import pvalues
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               tree_global_norm, warmup_cosine)
from repro_torch.tree import reference_leaves, tree_leaves, tree_map

TOL = 1e-6


def _cfgs():
    upd = dict(dtype="float32", param_dtype="float32", n_layers=3)
    return (dataclasses.replace(jax_reduced(jax_get_config("smollm-360m")), **upd),
            dataclasses.replace(reduced(get_config("smollm-360m")), **upd))


def _setup(seed=0):
    jcfg, cfg = _cfgs()
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3)
                          .astype(np.float32), vals) for _ in range(3)]
    return jcfg, cfg, jparams, vals, grads


def _close(port_tree, ref_vals, cfg):
    conv = params_from_jax(jax.tree.map(np.asarray, ref_vals), cfg, device="cpu")
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), atol=TOL, rtol=TOL), port_tree, conv)


def test_train_config_is_a_copy():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


@pytest.mark.parametrize("warmup,total", [(0, 8), (10, 100), (100, 1000)])
def test_warmup_cosine_matches(warmup, total):
    for step in list(range(0, total + 3, max(1, total // 25))) + [warmup]:
        ref = float(jax_warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                                      total_steps=total))
        got = warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                            total_steps=total)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches(max_norm):
    _, cfg, _, _, grads = _setup()
    jclipped, jnorm = jax_clip(jax.tree.map(jnp.asarray, grads[0]), max_norm)
    clipped, norm = clip_by_global_norm(params_from_jax(grads[0], cfg, "cpu"),
                                        max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=TOL)
    _close(clipped, jclipped, cfg)


def test_clip_keeps_each_grads_dtype():
    g = {"a": torch.full((4,), 3.0, dtype=torch.bfloat16),
         "b": torch.full((2,), 4.0)}
    out, norm = clip_by_global_norm(g, 1.0)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    assert float(norm) == pytest.approx(float(tree_global_norm(g)))
    assert float(tree_global_norm(out)) == pytest.approx(1.0, rel=1e-2)


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_updates_match(name):
    jcfg, cfg, jparams, vals, grads = _setup()
    jtcfg = JTrainConfig(optimizer=name, warmup_steps=1, total_steps=4)
    tcfg = TrainConfig(optimizer=name, warmup_steps=1, total_steps=4)
    jinit, jupd = jax_make_optimizer(name)
    init, upd = make_optimizer(name)
    params = params_from_jax(vals, cfg, device="cpu")
    jstate, state = jinit(jparams, jtcfg), init(params, tcfg)
    for step, g in enumerate(grads):
        lr = warmup_cosine(step, peak_lr=1e-2, warmup_steps=1, total_steps=4)
        jparams, jstate = jupd(jparams, jax.tree.map(jnp.asarray, g), jstate,
                               jtcfg, jnp.float32(lr))
        params, state = upd(params, params_from_jax(g, cfg, "cpu"), state,
                            tcfg, lr)
        _close(params, pvalues(jparams), cfg)
    assert state.step == int(jstate.step) == len(grads)
    if name in ("adamw", "sgd"):
        _close(state.mu, pvalues(jstate.mu), cfg)
    if name == "adamw":
        _close(state.nu, pvalues(jstate.nu), cfg)
    if name == "adafactor":
        # one (row, col) / (full,) tuple per reference leaf, in its layout
        ref_nu = pvalues(jstate.nu)
        for (path, _), got in zip(reference_leaves(params), state.nu):
            node = ref_nu
            for key in path:
                node = node["kernel" if key == "weight" else key]
            assert len(got) == len(node)
            for a, b in zip(got, node):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=TOL, rtol=TOL)


def test_optimizers_are_functional_and_keep_dtypes():
    """Updates write into the given params and state and return those
    tensors (the step's donated state); bf16 params stay bf16, state is
    fp32."""
    g = {"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16)}
    for name in ("adamw", "sgd", "adafactor"):
        p = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
        init, upd = make_optimizer(name)
        state = init(p, TrainConfig())
        moments = [t for t in tree_leaves([state.mu, state.nu]) if t is not None]
        new, new_state = upd(p, g, state, TrainConfig(), 1e-2)
        assert new["w"] is p["w"] and new["w"].dtype == torch.bfloat16
        assert not torch.equal(p["w"], torch.ones(3, 2, dtype=torch.bfloat16))
        assert all(a is b for a, b in zip(
            [t for t in tree_leaves([new_state.mu, new_state.nu]) if t is not None],
            moments)) and moments
        assert all(t.dtype == torch.float32 for t in moments)
