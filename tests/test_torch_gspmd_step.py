"""Port parity: the GSPMD train step over a mesh of ranks
(``repro_torch.train.step.make_gspmd_train_step``) against the port's
single-device ``make_train_step`` and the reference's un-jitted
``make_train_step``, on reduced smollm-360m in fp32 from the reference's
init, three steps, on one gloo ``Pool`` of 4 CPU ranks at mesh {data 2,
model 2} for the module.

Cases: fsdp_tp (the MLP split on model, the embedding over data) and dp,
each with adamw and no codec, and with int8_ef under sgd (the reference's
codec test, C5); adafactor under fsdp_tp (the whole-leaf update); two
microbatches under fsdp_tp; and labels with MASK_ID on some rows, so the
data ranks' rows hold unequal label counts, whole and in two microbatches
(the loss is one mean over every label, as the reference's program takes
it, not a mean of the ranks' means).

Tolerances. The GSPMD step sums the gradients of two data shards and the
Megatron partials of two model ranks where the single-device step sums
one batch: fp32 sums in other orders. Losses within 1e-5 relative; with no
codec, params and moments within atol 1e-5 (adamw moves a param by at most
about lr = 3e-4 a step; ``test_torch_train``'s tier), adafactor's too. With
int8_ef, C5's conditions: per reference leaf, params within steps · lr ·
scale and residuals within one quantization step (the leaf's scale, from
its largest reduced gradient), and at most 1e-3 of the elements a rounding
flip away (a gradient that differs in its last fp32 bits can land on the
other side of a half-ulp boundary of the codec).
"""
import dataclasses
import os
import sys

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
from repro.train import step as JTS
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist.pool import Pool
from repro_torch.models.convert import params_from_jax
from repro_torch.train import step as TS
from repro_torch.tree import reference_leaves, tree_leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_pool_jobs as jobs  # noqa: E402

MESH = {"data": 2, "model": 2}
B, S, STEPS = 4, 16, 3
RED = dict(n_kv_heads=2)          # 4 q heads over 2 kv heads: both divide 2
ADAMW = dict(optimizer="adamw", warmup_steps=1, total_steps=STEPS)
SGD = dict(optimizer="sgd", warmup_steps=0, total_steps=STEPS, learning_rate=1e-2)
CASES = {
    "fsdp_tp-adamw-none": ("fsdp_tp", dict(ADAMW, grad_compression="none"), 1),
    "dp-adamw-none": ("dp", dict(ADAMW, grad_compression="none"), 1),
    "fsdp_tp-sgd-int8_ef": ("fsdp_tp", dict(SGD, grad_compression="int8_ef"), 1),
    "dp-sgd-int8_ef": ("dp", dict(SGD, grad_compression="int8_ef"), 1),
    "fsdp_tp-adafactor-none": ("fsdp_tp", dict(optimizer="adafactor", warmup_steps=0,
                                               total_steps=STEPS,
                                               grad_compression="none"), 1),
    "fsdp_tp-adamw-microbatches": ("fsdp_tp", dict(ADAMW, grad_compression="none"), 2),
    "fsdp_tp-adamw-masked": ("fsdp_tp", dict(ADAMW, grad_compression="none"), 1),
    "fsdp_tp-adamw-masked-microbatches": ("fsdp_tp", dict(ADAMW, grad_compression="none"),
                                          2),
}
MASK_ID = -1                      # the label the loss leaves out


def _cfgs():
    upd = dict(RED, dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config("smollm-360m")), **upd),
            dataclasses.replace(reduced(get_config("smollm-360m")), **upd))


def _batches(cfg, masked=False):
    """Seeded token batches; ``masked``: next-token labels with MASK_ID over
    most of rows 0 and 3 (data rank 0 holds rows 0-1, rank 1 rows 2-3; each
    of two microbatches gives each rank one row), a different count a row."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        b = {"tokens": tokens}
        if masked:
            labels = np.concatenate([tokens[:, 1:], np.full((B, 1), MASK_ID, np.int32)], 1)
            labels[0, 3:] = MASK_ID
            labels[3, 11:] = MASK_ID
            labels[1, :2] = MASK_ID
            b["labels"] = labels
        out.append(b)
    return out


@pytest.fixture(scope="module")
def pool():
    with Pool(world=4, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = JMD.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, pvalues(jparams))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _single(cfg, tcfg, tree, batches, microbatches):
    """The single-device step: (losses, final state, per tensor the largest
    |gradient| over the steps, the codec's scale bound, grad norms)."""
    params = params_from_jax(tree, cfg, device="cpu")
    opt_init, _ = TS.make_optimizer(tcfg.optimizer)
    ef = (TS.init_error_feedback(params) if tcfg.grad_compression == "int8_ef"
          else None)
    state = TS.TrainState(params, opt_init(params, tcfg), ef)
    step = TS.make_train_step(cfg, tcfg, microbatches=microbatches)
    grad_fn = TS._grad_fn(cfg, tcfg)
    losses, gnorms, gmax = [], [], None
    for b in batches:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        m = [float(g.abs().max()) for g in tree_leaves(grad_fn(state.params, tb)[2])]
        gmax = m if gmax is None else [max(x, y) for x, y in zip(gmax, m)]
        state, metrics = step(state, tb)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    return losses, state, gmax, gnorms


def _reference(jcfg, jtcfg, jparams, batches, microbatches):
    jstate = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    jstate = jstate._replace(params=jparams)
    step = JTS.make_train_step(jcfg, jtcfg, microbatches=microbatches)
    losses = []
    for b in batches:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jstate


def _leaves_np(tree, cfg):
    return [_np(x) for x in tree_leaves(params_from_jax(
        jax.tree.map(np.asarray, pvalues(tree)), cfg, device="cpu"))]


def _close(got, want, atol, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {i}")


def _codec_close(got, want, grads_max, params_tree, lr, what):
    """C5's conditions: params within STEPS·lr·scale, residuals within a
    scale per reference leaf; flips at most 1e-3 of the elements."""
    flips = total = 0
    for _, idx in reference_leaves(params_tree):
        scale = max(grads_max[i] for i in idx) / 127.0
        for i in idx:
            np.testing.assert_allclose(got["ef"][i], want["ef"][i], rtol=0,
                                       atol=scale * 1.001 + 1e-7, err_msg=f"{what} ef {i}")
            np.testing.assert_allclose(got["params"][i], want["params"][i], rtol=0,
                                       atol=STEPS * lr * scale * 1.001 + 1e-6,
                                       err_msg=f"{what} params {i}")
            flips += int((np.abs(got["ef"][i] - want["ef"][i]) > scale / 2).sum())
            total += got["ef"][i].size
    assert flips <= total * 1e-3, (what, flips, total)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gspmd_step_matches_single_device_and_reference(pool, model, case):
    strategy, kw, mb = CASES[case]
    jcfg, cfg, jparams, tree = model
    batches = _batches(cfg, masked="masked" in case)
    tcfg = TrainConfig(remat_policy="none", **kw)
    jtcfg = JTrainConfig(remat_policy="none", **kw)
    res = pool.run(jobs.gspmd_steps, cfg, tcfg, strategy, tree, batches, mb, mesh=MESH)
    got = res[0]["state"]
    assert all(r["losses"] == res[0]["losses"] for r in res)   # one loss on every rank
    s_losses, s_state, gmax, s_gnorms = _single(cfg, tcfg, tree, batches, mb)
    np.testing.assert_allclose(res[0]["losses"], s_losses, rtol=1e-5)
    np.testing.assert_allclose(res[0]["grad_norm"], s_gnorms, rtol=1e-4)
    single = {k: None if t is None else [_np(x) for x in tree_leaves(t)]
              for k, t in (("params", s_state.params), ("mu", s_state.opt.mu),
                           ("nu", s_state.opt.nu), ("ef", s_state.ef))}
    if tcfg.grad_compression == "none":
        for part in ("params", "mu", "nu"):
            if single[part] is not None:
                _close(got[part], single[part], 1e-5, f"{case} {part} vs single")
            else:
                assert got[part] is None
    if tcfg.optimizer == "adafactor":
        return                              # the reference's factored tree differs
    r_losses, jstate = _reference(jcfg, jtcfg, jparams, batches, mb)
    np.testing.assert_allclose(res[0]["losses"], r_losses, rtol=1e-5)
    ref = {"params": _leaves_np(jstate.params, cfg),
           "ef": None if jstate.ef is None else _leaves_np(jstate.ef, cfg)}
    if tcfg.grad_compression == "int8_ef":
        _codec_close(got, single, gmax, s_state.params, tcfg.learning_rate,
                     f"{case} vs single")
        _codec_close(got, ref, gmax, s_state.params, tcfg.learning_rate,
                     f"{case} vs reference")
    else:
        _close(got["params"], ref["params"], 1e-5, f"{case} params vs reference")
        for part, jtree in (("mu", jstate.opt.mu), ("nu", jstate.opt.nu)):
            _close(got[part], _leaves_np(jtree, cfg), 1e-5, f"{case} {part} vs reference")


def test_gspmd_state_specs_place_the_state(model):
    """Every rank's slices are the specs' blocks of the whole state."""
    _, cfg, _, _ = model
    tcfg = TrainConfig(optimizer="adamw", grad_compression="int8_ef")
    specs = TS.gspmd_state_specs(cfg, tcfg, MESH, "fsdp_tp")
    shapes = TS.MD.param_shapes(cfg)
    assert specs.opt.mu == specs.params == specs.opt.nu == specs.ef
    assert specs.params == TS.param_pspecs(shapes, MESH, "fsdp_tp")
