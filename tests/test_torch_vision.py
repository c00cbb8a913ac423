"""Port parity for the vision stub (reduced internvl2-76b): precomputed
patch embeddings prepended to the text, their positions' labels masked,
through the reference package and the port on the same weights.

Tolerances are those of ``test_torch_train.py`` and ``test_torch_serve.py``:
the loss within 1e-5 relative, grads within atol 1e-5 and rtol 1e-4, bf16
logits within one bf16 ulp (floor 1e-6), fp32 caches within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import make_batch_for as jax_make_batch_for
from repro.models import model as JMD
from repro.models.layers import pvalues
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.train import step as TS
from repro_torch.tree import tree_leaves, tree_map

ARCH = "internvl2-76b"
B = 2


def _cfgs():
    upd = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **upd),
            dataclasses.replace(reduced(get_config(ARCH)), **upd))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _setup(seed=0, seq=24):
    jcfg, cfg = _cfgs()
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, pvalues(jparams)), cfg, device="cpu")
    jb = jax_make_batch_for(jcfg, B, seq, step=seed, seed=seed)
    tb = make_batch_for(cfg, B, seq, step=seed, seed=seed)
    return jcfg, cfg, jparams, params, jb, tb


def test_loss_masks_the_patches_and_grads_match():
    """16 patch positions and 8 text tokens: the loss counts the 7 next-token
    labels of each row only; loss and every grad against ``jax.grad``."""
    jcfg, cfg, jparams, params, jb, tb = _setup()
    assert tuple(tb["patches"].shape) == (B, cfg.n_frontend_tokens, cfg.d_model)
    assert tuple(tb["tokens"].shape) == (B, 24 - cfg.n_frontend_tokens)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jb, remat="none"), has_aux=True)(jparams)
    loss, m, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(m["tokens"]) == int(jm["tokens"]) == B * 7
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jg)), cfg, device="cpu")
    tree_map(lambda a, b: np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-4),
             grads, ref)


def test_prefill_prepends_the_patches():
    """Prefill over patches + tokens: last logits within one bf16 ulp of the
    reference's, caches over all 24 positions; the patches move them."""
    jcfg, cfg, jparams, params, jb, tb = _setup(seed=1)
    jl, jc, _ = JMD.prefill(jparams, jcfg, jb)
    pl, pc = MD.prefill(params, cfg, tb)
    np.testing.assert_allclose(_np(pl), _np(jl), rtol=2.0 ** -7, atol=1e-6)
    assert tuple(pc[0][0].shape)[:3] == (cfg.n_layers, B, 24)
    for a, b in zip(tree_leaves(list(pc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)
    moved, _ = MD.prefill(params, cfg, {**tb, "patches": tb["patches"] * 2})
    assert not torch.equal(moved, pl)


def test_remat_full_recomputes_the_same_loss_and_grads():
    _, cfg, _, params, _, tb = _setup(seed=2)
    ref = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tb)
    got = TS._grad_fn(cfg, TrainConfig(remat_policy="full"))(params, tb)
    assert float(got[0]) == float(ref[0])
    tree_map(lambda a, b: np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-6),
             got[2], ref[2])
