"""Port parity for the hybrid SSM family: zamba2-1.2b's ``zamba_group``
(``inner`` Mamba2 blocks, then one attention/MLP block whose weights every
group shares) through the reference package and the port on the same
weights.

``reduced(zamba2)`` keeps ``shared_attn_every = 6`` at 2 layers, which
builds no group at all, so these tests run ``n_layers = 5,
shared_attn_every = 2``: two groups of two Mamba2 blocks each followed by
the shared block, then one plain ``ssm`` segment. Weights come from the
reference's ``init_model`` with every rmsnorm scale (and Mamba2's gated
norm scale) overwritten by seeded values. Tolerances are those of
``test_torch_ssm.py`` and ``test_torch_train.py``: fp32 hidden states and
caches within 1e-4, bf16 logits within one bf16 ulp (floor 1e-6), the loss
within 1e-5 relative, grads within atol 1e-5 and rtol 1e-4 (the shared
block's is the sum over its two applications, held against ``jax.grad``),
adamw steps' params within 1e-5 and an adafactor step's within 2e-3·lr
(its update g/sqrt(v) is of order 1 whatever |g|, so where |g| is small
the grad's fp32 rounding reaches the params at ~1e-3·lr); the int8 codec
bit for bit; bf16 at 2e-2. The reference is called un-jitted, so that its codec divides by 127.
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
from repro.dist import compression as JC
from repro.models import model as JMD
from repro.models.layers import pvalues, with_values
from repro.optim import optimizers as JO
from repro.train import step as JTS
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist import compression as C
from repro_torch.dist.compression import init_error_feedback
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import make_optimizer
from repro_torch.train import step as TS
from repro_torch.tree import reference_leaves, stack_dims, tree_leaves, tree_map

ARCH = "zamba2-1.2b"
BF16_ULP = 2.0 ** -7
HIDDEN_TOL = 1e-4
B, T = 2, 12
GROUPS = dict(n_layers=5, shared_attn_every=2)


def _cfgs(fp32=True, **upd):
    upd = {**GROUPS, **upd}
    if fp32:
        upd.update(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **upd),
            dataclasses.replace(reduced(get_config(ARCH)), **upd))


def _perturb_scales(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_scales(v, rng)
        elif k in ("scale", "norm_scale"):
            tree[k] = (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)


def _params(jcfg, cfg, seed=0):
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    _perturb_scales(vals, np.random.default_rng(seed + 100))
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    return jparams, params_from_jax(vals, cfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _assert_ulp(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=BF16_ULP, atol=1e-6)


def _assert_nested_close(port, ref, tol):
    if isinstance(port, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_nested_close(p, r, tol)
        return
    assert tuple(port.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(port), _np(ref), atol=tol, rtol=tol)


def _convert(ref_tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, ref_tree), cfg, device="cpu")


def _assert_trees_close(port, ref, cfg, atol, rtol):
    conv = _convert(ref, cfg)
    assert len(tree_leaves(port)) == len(tree_leaves(conv))
    tree_map(lambda a, b: np.testing.assert_allclose(_np(a), _np(b), atol=atol,
                                                     rtol=rtol), port, conv)


def test_segments_and_param_tree():
    """Two groups of two and a remainder; the full config's six groups of
    six and two. One shared block a group segment; the tree's own count
    beside the reference's ``param_count``, which adds a dense MLP to every
    SSM layer of a hybrid."""
    _, cfg = _cfgs()
    segs = MD.build_segments(cfg)
    assert [(s.kind, s.n, s.inner) for s in segs] == [("zamba_group", 2, 2), ("ssm", 1, 0)]
    full = get_config(ARCH)
    assert [(s.kind, s.n, s.inner) for s in MD.build_segments(full)] == [
        ("zamba_group", 6, 6), ("ssm", 2, 0)]
    assert [s.kind for s in MD.build_segments(reduced(full))] == ["ssm"]
    p = MD.init_model(cfg, device="cpu")
    assert len(p["segments"][0]["inner"]) == 2 and len(p["segments"][0]["inner"][0]) == 2
    assert sorted(p["segments"][0]["shared"]) == ["attn", "ln1", "ln2", "mlp"]
    jp = JMD.init_model(jax.random.PRNGKey(0), _cfgs()[0])
    n_tree = sum(t.numel() for t in tree_leaves(p))
    assert n_tree == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(pvalues(jp)))
    assert cfg.param_count() == _cfgs()[0].param_count() > n_tree
    assert full.param_count() == 2_682_781_696


def test_hidden_forward_and_prefill_match():
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg)
    toks = _tokens(cfg, (B, T), 1)
    jh, jcaches, _ = JMD.hidden_forward(
        jparams, jcfg, JMD.embed_tokens(jparams, jcfg, jnp.asarray(toks)),
        positions=jnp.arange(T), keep_cache=True)
    h, caches, _ = MD.hidden_forward(
        params, cfg, MD.embed_tokens(params, cfg, torch.from_numpy(toks)),
        positions=torch.arange(T, dtype=torch.int32), keep_cache=True)
    np.testing.assert_allclose(_np(h), _np(jh), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    _assert_nested_close(caches, jcaches, HIDDEN_TOL)
    jlogits, _, _ = JMD.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits, _ = MD.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    _assert_ulp(logits, jlogits)


def test_decode_steps_match():
    """T decode steps (the Mamba2 recurrence, the shared block's ring cache
    per group): logits each step, then every cache, against the reference's
    ``decode_step``; the last logits against the port's prefill."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg, seed=1)
    toks = _tokens(cfg, (B, T), 2)
    jc = JMD.init_decode_caches(jcfg, B, T, dtype=jnp.float32)
    c = MD.init_decode_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    _assert_nested_close(c, jc, 0)                # shapes [groups, inner, ...]
    assert tuple(c[0][1][0].shape) == (2, B, T, cfg.n_kv_heads, cfg.get_head_dim())
    for pos in range(T):
        jl, jc = JMD.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, pos:pos + 1]), pos)
        dl, c = MD.decode_step(params, cfg, c, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        _assert_ulp(dl, jl)
    _assert_nested_close(c, jc, HIDDEN_TOL)
    pre, _ = MD.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(dl), _np(pre), atol=5e-3, rtol=5e-3)


def _batches(cfg, seed, b=B, s=40):                 # two chunks of 32, padded
    toks = _tokens(cfg, (b, s), seed)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match(remat):
    """Loss and every grad against ``jax.grad`` under the reference's remat
    policy of the same name (under "full" a group's two Mamba2 blocks and
    the shared block recompute together). The shared block's grad is the
    sum of its two applications'."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batches(cfg, 1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jbatch, remat=remat), has_aux=True)(jparams)
    loss, metrics, grads = TS._grad_fn(cfg, TrainConfig(remat_policy=remat))(params, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    _assert_trees_close(grads, pvalues(jgrads), cfg, atol=1e-5, rtol=1e-4)
    # the sum of two applications: both groups reach the shared block
    one = dataclasses.replace(cfg, n_layers=2)
    _, g1 = TS._grad_fn(one, TrainConfig(remat_policy="none"))(
        {**params, "segments": [{"inner": params["segments"][0]["inner"][:1],
                                 "shared": params["segments"][0]["shared"]}]}, tbatch)[1:]
    assert not torch.allclose(g1["segments"][0]["shared"]["mlp"]["up"]["weight"],
                              grads["segments"][0]["shared"]["mlp"]["up"]["weight"])


def test_reference_leaves_stack_groups_and_layers():
    """Each inner Mamba2 leaf is ONE reference leaf over groups × inner
    layers; the shared block's leaves and the remainder segment's are their
    own; ``stack_dims`` gives adafactor the reference's shapes."""
    _, cfg = _cfgs(fp32=False)
    params = MD.init_model(cfg, seed=0, device="cpu")
    groups = dict(reference_leaves(params))
    inner = {k: v for k, v in groups.items() if k[:3] == ("segments", 0, "inner")}
    shared = {k: v for k, v in groups.items() if k[:3] == ("segments", 0, "shared")}
    rem = {k: v for k, v in groups.items() if k[:2] == ("segments", 1)}
    assert len(inner) == len(rem) == 9 and len(shared) == 9
    assert all(len(v) == 4 for v in inner.values())
    assert all(len(v) == 1 for v in list(shared.values()) + list(rem.values()))
    assert ("segments", 0, "inner", "mamba", "in_proj", "weight") in inner
    assert stack_dims(params, ("segments", 0, "inner", "ln", "scale")) == (2, 2)
    assert stack_dims(params, ("segments", 0, "shared", "ln1", "scale")) == ()
    assert stack_dims(params, ("segments", 1, "ln", "scale")) == (1,)
    assert sum(len(v) for v in groups.values()) == len(tree_leaves(params))
    jvals = pvalues(JMD.init_model(jax.random.PRNGKey(0), _cfgs(fp32=False)[0]))
    assert len(groups) == len(jax.tree.leaves(jvals))


LAYER_MAGNITUDES = np.asarray([[0.05, 3.0], [0.4, 11.0]], np.float32)


@pytest.mark.parametrize("mode", ["int8", "int8_ef"])
def test_compress_tree_bit_equal(mode):
    """int8 and int8_ef over a reduced zamba2 grads tree in the reference's
    layout, each (group, layer) of an inner leaf at its own magnitude:
    compressed grads and residuals of three steps bit for bit against the
    reference's codec, one scale per reference leaf (the inner leaves' over
    all four layers)."""
    jcfg, cfg = _cfgs()
    skel = jax.tree.map(np.asarray, pvalues(JMD.init_model(jax.random.PRNGKey(0), jcfg)))
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), skel)
    tree["segments"][0]["inner"] = jax.tree.map(
        lambda g: g * LAYER_MAGNITUDES.reshape((2, 2) + (1,) * (g.ndim - 2)),
        tree["segments"][0]["inner"])
    port = params_from_jax(tree, cfg, device="cpu")
    jgrads = jax.tree.map(jnp.asarray, tree)
    jef = tef = None
    for _ in range(3):
        jd, jef = JC.compress_tree(jgrads, mode, jef)
        td, tef = C.compress_tree(port, mode, tef)
        pairs = [(td, jd)] + ([(tef, jef)] if mode == "int8_ef" else [])
        for got, ref in pairs:
            conv = tree_leaves(_convert(ref, cfg))
            assert len(conv) == len(tree_leaves(got))
            for a, b in zip(tree_leaves(got), conv):
                np.testing.assert_array_equal(a.numpy().view(np.int32),
                                              b.numpy().view(np.int32))


def _states(jcfg, cfg, jtcfg, tcfg, seed=0):
    jparams, params = _params(jcfg, cfg, seed)
    jstate = JTS.init_train_state(jax.random.PRNGKey(seed), jcfg, jtcfg)
    jstate = jstate._replace(params=jparams)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    ef = init_error_feedback(params) if tcfg.grad_compression == "int8_ef" else None
    return jstate, TS.TrainState(params, opt_init(params, tcfg), ef)


def test_train_steps_adamw():
    """Two adamw steps under remat "full" against the reference's un-jitted
    step, params at atol 1e-5."""
    jcfg, cfg = _cfgs()
    kw = dict(optimizer="adamw", remat_policy="full", warmup_steps=1, total_steps=4)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jstep, step = JTS.make_train_step(jcfg, jtcfg), TS.make_train_step(cfg, tcfg)
    for i in range(2):
        jbatch, tbatch = _batches(cfg, 10 + i)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_trees_close(state.params, pvalues(jstate.params), cfg, atol=1e-5, rtol=0)


def test_adafactor_step_factors_the_two_level_stack():
    """adafactor factors an inner leaf in the reference's [groups, inner,
    ...] shape: one step's params and moments against the reference's."""
    jcfg, cfg = _cfgs()
    kw = dict(optimizer="adafactor", remat_policy="none", warmup_steps=0,
              total_steps=4, learning_rate=1e-2)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jbatch, tbatch = _batches(cfg, 3)
    jnew, jm = JTS.make_train_step(jcfg, jtcfg)(jstate, jbatch)
    new, m = TS.make_train_step(cfg, tcfg)(state, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_trees_close(new.params, pvalues(jnew.params), cfg, atol=2e-3 * tcfg.learning_rate,
                        rtol=1e-5)
    groups = reference_leaves(new.params)
    (i,) = [i for i, (k, _) in enumerate(groups)
            if k == ("segments", 0, "inner", "mamba", "out_proj", "weight")]
    row, col = new.opt.nu[i]
    s = cfg.ssm
    assert tuple(row.shape) == (2, 2, s.expand * cfg.d_model)
    assert tuple(col.shape) == (2, 2, cfg.d_model)


def test_bf16_loss_grads_and_decode_at_bf16_tolerance():
    jcfg, cfg = _cfgs(fp32=False)
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batches(cfg, 1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jbatch, remat="none"), has_aux=True)(jparams)
    loss, _, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.dtype == p.dtype
    _assert_trees_close(grads, pvalues(jgrads), cfg, atol=2e-2, rtol=2e-2)
    toks = _tokens(cfg, (B, 8), 4)
    jc = JMD.init_decode_caches(jcfg, B, 8)
    c = MD.init_decode_caches(cfg, B, 8, device="cpu")
    for pos in range(8):
        jl, jc = JMD.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, pos:pos + 1]), pos)
        dl, c = MD.decode_step(params, cfg, c, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(_np(dl), _np(jl), atol=2e-2, rtol=2e-2)
