"""Port parity for the training slice as a whole: reduced smollm-360m through
the reference's loss, grads and train step and the port's, on the same
weights and tokens.

Weights come from the reference's ``init_model`` with its rmsnorm scales
(ones at init) overwritten by seeded values, so a norm bug cannot pass
unseen. Two head layouts: the reduced config's 4 q heads over 4 kv heads,
and 4 over 2. The reference step is called un-jitted, so that its codec
divides by 127 eagerly (under ``jit`` XLA turns that divide into a multiply
by the reciprocal, one scale-ulp away; ``repro/kernels/quantize.py``).

Tolerances, fp32: the loss within 1e-5 relative and grads within atol 1e-5,
rtol 1e-4 (fp32 sums in other orders through two layers, attention and a
512-way log-softmax); after an int8_ef step, params and error-feedback
residuals within one quantization step of their reference leaf, because
grads that differ in the last fp32 bits can land on either side of a
half-ulp rounding boundary of the codec. bf16: 2e-2, as the reference's
kernel tests use for bf16.
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
from repro.models.layers import pvalues, with_values
from repro.train import step as JTS
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist.compression import init_error_feedback
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import make_optimizer
from repro_torch.train import step as TS
from repro_torch.tree import reference_leaves, tree_leaves, tree_map

VARIANTS = {"h4kv4": {}, "h4kv2": {"n_kv_heads": 2}}
B, S = 4, 16


def _cfgs(variant, fp32=True):
    upd = dict(VARIANTS[variant])
    if fp32:
        upd.update(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config("smollm-360m")), **upd),
            dataclasses.replace(reduced(get_config("smollm-360m")), **upd))


def _params(jcfg, cfg, seed=0):
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    rng = np.random.default_rng(seed + 100)

    def like(a):
        return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)

    seg = vals["segments"][0]
    for ln in ("ln1", "ln2"):
        seg[ln]["scale"] = like(seg[ln]["scale"])
    vals["final_norm"]["scale"] = like(vals["final_norm"]["scale"])
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    return jparams, params_from_jax(vals, cfg, device="cpu")


def _batch(cfg, seed=1, b=B):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, S),
                                                dtype=np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _convert(ref_tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, ref_tree), cfg, device="cpu")


def _assert_trees_close(port, ref, cfg, atol, rtol):
    tree_map(lambda a, b: np.testing.assert_allclose(_np(a), _np(b), atol=atol,
                                                     rtol=rtol),
             port, _convert(ref, cfg))


def _jax_loss_and_grads(jparams, jcfg, jbatch):
    def loss_for(p):
        return JMD.loss_fn(p, jcfg, jbatch, remat="none")
    (loss, _), grads = jax.value_and_grad(loss_for, has_aux=True)(jparams)
    return loss, pvalues(grads)


def _port_loss_and_grads(params, cfg, tbatch, remat="none"):
    tcfg = TrainConfig(remat_policy=remat)
    loss, metrics, grads = TS._grad_fn(cfg, tcfg)(params, tbatch)
    return loss, metrics, grads


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match(variant):
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batch(cfg)
    jloss, jgrads = _jax_loss_and_grads(jparams, jcfg, jbatch)
    loss, metrics, grads = _port_loss_and_grads(params, cfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(metrics["tokens"]) == B * (S - 1)
    _assert_trees_close(grads, jgrads, cfg, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_cross_entropy_matches(impl):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    labels[1, -1] = JMD.MASK_ID
    jsum, jn = JMD.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                 jnp.asarray(labels), impl=impl)
    tsum, tn = MD.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                                torch.from_numpy(labels), impl=impl)
    assert MD.MASK_ID == JMD.MASK_ID and int(tn) == int(jn) == 9
    np.testing.assert_allclose(float(tsum), float(jsum), rtol=1e-6)


def test_remat_full_recomputes_the_same_grads():
    """"full" and "dots" recompute the blocks in the backward and give
    "none"'s grads ("dots" keeps the dense products' outputs)."""
    _, cfg = _cfgs("h4kv2")
    _, params = _params(*_cfgs("h4kv2"))
    _, tbatch = _batch(cfg)
    loss0, _, g0 = _port_loss_and_grads(params, cfg, tbatch, remat="none")
    for remat in ("full", "dots"):
        loss1, _, g1 = _port_loss_and_grads(params, cfg, tbatch, remat=remat)
        assert float(loss0) == float(loss1)
        for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        _port_loss_and_grads(params, cfg, tbatch, remat="some")


def _states(jcfg, cfg, jtcfg, tcfg, seed=0):
    jparams, params = _params(jcfg, cfg, seed)
    jstate = JTS.init_train_state(jax.random.PRNGKey(seed), jcfg, jtcfg)
    jstate = jstate._replace(params=jparams)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    ef = (init_error_feedback(params)
          if tcfg.grad_compression == "int8_ef" else None)
    return jstate, TS.TrainState(params, opt_init(params, tcfg), ef)


def _tcfgs(**kw):
    return JTrainConfig(**kw), TrainConfig(**kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_sgd_int8_ef(variant):
    """One step through the codec: params and residuals within one
    quantization step (the leaf's scale) of the reference."""
    jcfg, cfg = _cfgs(variant)
    jtcfg, tcfg = _tcfgs(optimizer="sgd", grad_compression="int8_ef",
                         remat_policy="none", warmup_steps=0, total_steps=4,
                         learning_rate=1e-2)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jbatch, tbatch = _batch(cfg)
    _, jgrads = _jax_loss_and_grads(jstate.params, jcfg, jbatch)
    jnew, jm = JTS.make_train_step(jcfg, jtcfg)(jstate, jbatch)
    new, m = TS.make_train_step(cfg, tcfg)(state, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    ref_ef = tree_leaves(_convert(pvalues(jnew.ef), cfg))
    ref_p = tree_leaves(_convert(pvalues(jnew.params), cfg))
    g = tree_leaves(_convert(jgrads, cfg))
    ef, p = tree_leaves(new.ef), tree_leaves(new.params)
    lr = tcfg.learning_rate
    flips = 0
    for _, idx in reference_leaves(new.params):
        scale = max(float(np.abs(_np(g[i])).max()) for i in idx) / 127.0
        for i in idx:
            np.testing.assert_allclose(_np(ef[i]), _np(ref_ef[i]), rtol=0,
                                       atol=scale * 1.001 + 1e-7)
            np.testing.assert_allclose(_np(p[i]), _np(ref_p[i]), rtol=0,
                                       atol=lr * scale * 1.001 + 1e-6)
            flips += int((np.abs(_np(ef[i]) - _np(ref_ef[i])) > scale / 2).sum())
    total = sum(t.numel() for t in ef)
    assert flips <= total * 1e-3, (flips, total)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_steps_adamw_none(variant):
    """Two adamw steps without compression. AdamW divides each moment by
    its own root, so a grad element near zero can move its update by more
    than its grad's error: params are compared at atol 1e-5 (each step
    moves a param by at most about lr = 3e-4)."""
    jcfg, cfg = _cfgs(variant)
    jtcfg, tcfg = _tcfgs(optimizer="adamw", remat_policy="none",
                         warmup_steps=1, total_steps=4)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jstep, step = JTS.make_train_step(jcfg, jtcfg), TS.make_train_step(cfg, tcfg)
    for i in range(2):
        jbatch, tbatch = _batch(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    assert state.ef is None and state.opt.step == 2
    _assert_trees_close(state.params, pvalues(jstate.params), cfg,
                        atol=1e-5, rtol=0)


def test_train_step_microbatches():
    jcfg, cfg = _cfgs("h4kv2")
    jtcfg, tcfg = _tcfgs(optimizer="sgd", remat_policy="none",
                         warmup_steps=0, total_steps=4, learning_rate=1e-2)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jbatch, tbatch = _batch(cfg)
    jnew, jm = JTS.make_train_step(jcfg, jtcfg, microbatches=2)(jstate, jbatch)
    new, m = TS.make_train_step(cfg, tcfg, microbatches=2)(state, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    _assert_trees_close(new.params, pvalues(jnew.params), cfg,
                        atol=1e-6, rtol=1e-5)
    # accumulated grads are fp32 means over the microbatches
    _, _, acc = TS._loss_and_grads(TS._grad_fn(cfg, tcfg), state.params,
                                   tbatch, 2)
    _, _, whole = TS._grad_fn(cfg, tcfg)(state.params, tbatch)
    for a, w in zip(tree_leaves(acc), tree_leaves(whole)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-4)


def test_split_microbatches_rejects_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        TS._split_microbatches({"tokens": torch.zeros(3, 4)}, 2)


def test_bf16_loss_and_grads_at_bf16_tolerance():
    """bf16 weights and activations: the packages round bf16 at different
    places, so loss and grads agree to 2e-2; grads stay bf16."""
    jcfg, cfg = _cfgs("h4kv2", fp32=False)
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batch(cfg)
    jloss, jgrads = _jax_loss_and_grads(jparams, jcfg, jbatch)
    loss, _, grads = _port_loss_and_grads(params, cfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.dtype == p.dtype
    _assert_trees_close(grads, jgrads, cfg, atol=2e-2, rtol=2e-2)
