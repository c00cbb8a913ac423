"""Port parity for multi-head latent attention (``models/attention.py``'s
MLA) and for reduced deepseek-v3-671b as a whole (an ``mla_mlp`` layer, an
``mla_moe`` layer, the MTP head): the reference package and the port on the
same weights and inputs.

MLA's training and prefill path expands K/V out of the latent and attends
at qk dim 24 (nope 16 + rope 8) with v zero-padded from 16; its decode is
the absorbed form over the latent cache. Weights come from the reference's
``init_mla``/``init_model`` with every rmsnorm scale overwritten by seeded
values. Tolerances (fp32): MLA outputs and caches within 1e-5, hidden
states within 1e-4, bf16 logits within one bf16 ulp with an absolute floor
of 1e-5, the loss and its parts within 1e-5 relative, grads within rtol
1e-4 and atol 1e-5 × max(1, the leaf's largest |grad|); decode against the
port's own full forward at 5e-3 (the reference's ``test_serve.py``); bf16
at 2e-2. The floors are above the dense archs' (1e-6 and 1e-5): the
stacked experts take the reference's scale 1/sqrt(E) (0.5 here), so the
residual stream and the embedding's grad (largest |g| ~6) are larger and
their fp32 sums carry more absolute rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as JA
from repro.models import model as JMD
from repro.models.layers import pvalues, with_values
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.models import attention as A
from repro_torch.models import model as MD
from repro_torch.models.convert import _convert, params_from_jax
from repro_torch.train import step as TS
from repro_torch.tree import tree_leaves, tree_map

ARCH = "deepseek-v3-671b"
BF16_ULP = 2.0 ** -7
HIDDEN_TOL = 1e-4
LOGIT_FLOOR = 1e-5
B, T = 2, 12


def _cfgs(fp32=True, **upd):
    if fp32:
        upd.update(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **upd),
            dataclasses.replace(reduced(get_config(ARCH)), **upd))


def _perturb_scales(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_scales(v, rng)
        elif k == "scale":
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


def _assert_nested_close(port, ref, tol):
    if isinstance(port, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_nested_close(p, r, tol)
        return
    np.testing.assert_allclose(_np(port), _np(ref), atol=tol, rtol=tol)


def _mla(seed=0):
    jcfg, cfg = _cfgs()
    jp = JA.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, _convert(jax.tree.map(np.asarray, pvalues(jp)), "cpu")


@pytest.mark.parametrize("window", [0, 5])
def test_mla_naive_forward_matches(window):
    jcfg, cfg, jp, p = _mla()
    x = np.random.default_rng(1).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    spec, jspec = A.AttnSpec(window=window), JA.AttnSpec(window=window)
    jy, jc = JA.mla_forward(jp, jnp.asarray(x), jcfg, jspec, jnp.asarray(pos))
    y, c = A.mla_forward(p, torch.from_numpy(x), cfg, spec, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=1e-5)
    _assert_nested_close(c, jc, 1e-5)
    m = cfg.mla
    assert tuple(c[0].shape) == (B, T, m.kv_lora_rank)
    assert tuple(c[1].shape) == (B, T, m.qk_rope_head_dim)


def test_mla_absorbed_decode_matches():
    """T decode steps over a latent ring of T - 4 slots (it wraps): each
    step's output and the caches against the reference's absorbed decode,
    and the steps before the wrap against the naive forward's rows."""
    jcfg, cfg, jp, p = _mla(seed=2)
    x = np.random.default_rng(3).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    m, cap = cfg.mla, T - 4
    jcache = (jnp.zeros((B, cap, m.kv_lora_rank)), jnp.zeros((B, cap, m.qk_rope_head_dim)),
              jnp.full((cap,), JA.PAD_POS, jnp.int32))
    cache = tuple(torch.from_numpy(np.array(a)) for a in jcache)
    full, _ = A.mla_forward(p, torch.from_numpy(x), cfg, A.AttnSpec(),
                            torch.arange(T, dtype=torch.int32))
    for t in range(T):
        pos = np.array([t], np.int32)
        jy, jcache = JA.mla_forward(jp, jnp.asarray(x[:, t:t + 1]), jcfg, JA.AttnSpec(),
                                    jnp.asarray(pos), jcache, t)
        y, cache = A.mla_forward(p, torch.from_numpy(x[:, t:t + 1]), cfg, A.AttnSpec(),
                                 torch.from_numpy(pos), cache, t)
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=1e-5)
        if t < cap:
            np.testing.assert_allclose(_np(y), _np(full[:, t:t + 1]), atol=1e-5, rtol=1e-5)
    _assert_nested_close(cache, jcache, 1e-5)
    np.testing.assert_array_equal(cache[2].numpy(), [8, 9, 10, 11, 4, 5, 6, 7])


def _assert_grad_close(a, b):
    b = _np(b)
    np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(b).max())))


def _batches(cfg, seed, b=B, s=16):
    toks = _tokens(cfg, (b, s), seed)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def test_deepseek_segments_and_mtp_tree():
    _, cfg = _cfgs()
    assert [(s.kind, s.n) for s in MD.build_segments(cfg)] == [("mla_mlp", 1), ("mla_moe", 1)]
    full = get_config(ARCH)
    assert [(s.kind, s.n) for s in MD.build_segments(full)] == [("mla_mlp", 3), ("mla_moe", 58)]
    p = MD.init_model(cfg, device="cpu")
    assert sorted(p["mtp"]) == ["block", "norm_e", "norm_h", "proj"]
    assert "attn" in p["mtp"]["block"] and "wq_a" in p["mtp"]["block"]["attn"]
    jp = JMD.init_model(jax.random.PRNGKey(0), _cfgs()[0])
    assert len(tree_leaves(p)) == len(jax.tree.leaves(pvalues(jp)))   # one layer a segment


def test_deepseek_loss_with_mtp_and_grads_match():
    """Loss, ce, aux and mtp_ce, and every grad (the mtp head's included)
    against ``jax.grad``."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batches(cfg, 1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jbatch, remat="none"), has_aux=True)(jparams)
    loss, m, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tbatch)
    for k in ("ce", "aux", "mtp_ce", "loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(m["aux"]) > 0 and int(m["tokens"]) == B * 15
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jgrads)), cfg, device="cpu")
    assert len(tree_leaves(grads)) == len(tree_leaves(ref))
    tree_map(_assert_grad_close, grads, ref)
    assert any(g.abs().sum() > 0 for g in tree_leaves(grads["mtp"]))


def test_deepseek_remat_full_recomputes_the_same_grads():
    jcfg, cfg = _cfgs()
    _, params = _params(jcfg, cfg, seed=1)
    _, tbatch = _batches(cfg, 2)
    ref = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tbatch)
    got = TS._grad_fn(cfg, TrainConfig(remat_policy="full"))(params, tbatch)
    assert float(got[0]) == float(ref[0])
    tree_map(lambda a, b: np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-6),
             got[2], ref[2])


def test_deepseek_prefill_and_decode_match():
    """Prefill (naive MLA, MoE over B·T tokens) and T decode steps (absorbed
    MLA over the latent cache, MoE over B tokens) against the reference's,
    logits and caches; decode's last logits against the port's prefill."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, cfg, seed=3)
    toks = _tokens(cfg, (B, T), 4)
    jlogits, jcaches, _ = JMD.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits, caches = MD.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=BF16_ULP, atol=LOGIT_FLOOR)
    _assert_nested_close(caches, jcaches, HIDDEN_TOL)
    jc = JMD.init_decode_caches(jcfg, B, T, dtype=jnp.float32)
    c = MD.init_decode_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    _assert_nested_close(c, jc, 0)
    for pos in range(T):
        jl, jc = JMD.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, pos:pos + 1]), pos)
        dl, c = MD.decode_step(params, cfg, c, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(_np(dl), _np(jl), rtol=BF16_ULP, atol=LOGIT_FLOOR)
    _assert_nested_close(c, jc, HIDDEN_TOL)
    np.testing.assert_allclose(_np(dl), _np(logits), atol=5e-3, rtol=5e-3)


def test_deepseek_bf16_loss_and_grads_at_bf16_tolerance():
    jcfg, cfg = _cfgs(fp32=False)
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batches(cfg, 5)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jbatch, remat="none"), has_aux=True)(jparams)
    loss, m, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    np.testing.assert_allclose(float(m["mtp_ce"]), float(jm["mtp_ce"]), rtol=2e-2)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.dtype == p.dtype
    assert params["segments"][1][0]["moe"]["router"].dtype == torch.float32
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jgrads)), cfg, device="cpu")
    tree_map(lambda a, b: np.testing.assert_allclose(
        _np(a), _np(b), atol=2e-2 * max(1.0, float(np.abs(_np(b)).max())), rtol=2e-2),
        grads, ref)
