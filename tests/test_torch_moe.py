"""Port parity for the mixture-of-experts block (``models/moe.py``): the
reference's ``moe_forward`` and the port's on the same weights and inputs.

Weights come from the reference's ``init_moe`` (fp32), converted by the
port's ``params_from_jax`` mapping (router and stacked experts keep their
layout, the shared expert's dense kernels are transposed). Cases: top-1 and
top-2 routing over 4 experts, with and without the shared expert, at the
reduced config's capacity factor (1.25) and at a capacity that drops most
slots. Tolerances: y within 1e-5 (atol and rtol, fp32), the aux loss within
1e-6 relative, grads of a seeded cotangent's dot with y plus the aux loss
within atol 1e-5 and rtol 1e-4 of ``jax.grad`` (at top-1 the router's
within atol 5e-4: there the renormalised weight p/p is 1, so the router's
grad through it is rounding noise in both packages, of order
ulp(1/p)·|dL/dw|, beside the aux loss's); the routing itself (ids, ranks,
kept slots) equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as JM
from repro.models.layers import pvalues
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as M
from repro_torch.models.convert import _convert

TOL = 1e-5
B, S = 2, 16


def _cfgs(top_k, shared, cf=1.25):
    def make(base):
        cfg = base(("llama4-scout-17b-a16e"))
        moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=top_k,
                                  n_shared_experts=shared, d_ff_shared=64 if shared else 0,
                                  capacity_factor=cf)
        return dataclasses.replace(cfg, moe=moe, dtype="float32", param_dtype="float32")
    return (make(lambda a: jax_reduced(jax_get_config(a))),
            make(lambda a: reduced(get_config(a))))


def _setup(top_k, shared, cf=1.25, seed=0):
    jcfg, cfg = _cfgs(top_k, shared, cf)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    vals = jax.tree.map(np.asarray, pvalues(jp))
    x = np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _convert(vals, "cpu"), x


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


CASES = [(1, 0), (1, 1), (2, 0), (2, 1)]


@pytest.mark.parametrize("top_k,shared", CASES)
def test_moe_forward_matches(top_k, shared):
    jcfg, cfg, jp, p, x = _setup(top_k, shared)
    ref = JM.moe_forward(jp, jnp.asarray(x), jcfg)
    out = M.moe_forward(p, torch.from_numpy(x), cfg)
    assert out.y.dtype == torch.float32 and tuple(out.y.shape) == x.shape
    np.testing.assert_allclose(_np(out.y), _np(ref.y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(ref.aux_loss), rtol=1e-6)
    assert ("shared" in p) == bool(shared)


@pytest.mark.parametrize("top_k,shared", CASES)
def test_moe_grads_match(top_k, shared):
    """Grads of sum(y * cot) + aux for the input and every parameter."""
    jcfg, cfg, jp, p, x = _setup(top_k, shared, seed=3)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(vals, xx):
        from repro.models.layers import with_values
        out = JM.moe_forward(with_values(jp, vals), xx, jcfg)
        return jnp.sum(out.y * cot) + out.aux_loss

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(pvalues(jp), jnp.asarray(x))
    leaves = {k: v for k, v in _flat(p)}
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = M.moe_forward(p, xt, cfg)
    (torch.sum(out.y * torch.from_numpy(cot)) + out.aux_loss).backward()
    np.testing.assert_allclose(_np(xt.grad), _np(jgx), atol=TOL, rtol=1e-4)
    ref = dict(_flat(_convert(jax.tree.map(np.asarray, jgp), "cpu")))
    assert sorted(ref) == sorted(leaves)
    for k, t in leaves.items():
        atol = 5e-4 if (k == ("router",) and top_k == 1) else TOL
        np.testing.assert_allclose(_np(t.grad), _np(ref[k]), atol=atol, rtol=1e-4, err_msg=k)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_drops_the_same_tokens(top_k):
    """A capacity factor of 8/(T·k) gives 2 slots an expert over 32 tokens,
    so most slots drop; the dropped slots (by the stable rank within each
    expert) and y are the reference's, and y differs from the dropless
    result."""
    T, E = B * S, 4
    jcfg, cfg, jp, p, x = _setup(top_k, 1, cf=8 / (T * top_k))
    assert M.expert_capacity(cfg.moe, T) == 2
    ref = JM.moe_forward(jp, jnp.asarray(x), jcfg)
    out = M.moe_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(out.y), _np(ref.y), atol=TOL, rtol=TOL)
    logits = x.reshape(T, -1) @ np.asarray(pvalues(jp)["router"])
    _, jids, _ = JM._topk_route(jnp.asarray(logits), jcfg.moe)
    _, ids, _ = M.topk_route(torch.from_numpy(logits), cfg.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    jr = np.asarray(JM._expert_ranks(jids.reshape(-1), E))
    r = M.expert_ranks(ids.reshape(-1), E).numpy()
    np.testing.assert_array_equal(r, jr)
    assert (r >= 2).sum() > T * top_k // 2          # most slots dropped
    free = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=E / top_k))
    assert not torch.allclose(M.moe_forward(p, torch.from_numpy(x), free).y, out.y)


def test_capacity_from_config():
    """C = ceil(int(cf·T·k) / E), at least 1: a decode step of 4 requests at
    llama4's top-1 over 16 experts gets one slot an expert; cf = E/k makes
    C = T, which drops nothing."""
    e = get_config("llama4-scout-17b-a16e").moe
    jcfg = jax_get_config("llama4-scout-17b-a16e")
    assert M.expert_capacity(e, 4) == 1
    assert M.expert_capacity(e, 4 * 32) == 10
    free = dataclasses.replace(e, capacity_factor=e.n_experts / e.top_k)
    d = get_config("deepseek-v3-671b").moe
    dfree = dataclasses.replace(d, capacity_factor=d.n_experts / d.top_k)
    for T in (1, 4, 128, 4096):
        assert M.expert_capacity(free, T) == T
        assert M.expert_capacity(dfree, T) == T
    assert dataclasses.asdict(e) == dataclasses.asdict(jcfg.moe)


def test_topk_ties_break_to_the_lower_expert():
    """Equal probabilities go to the lower expert id first, as lax.top_k."""
    jcfg, cfg = _cfgs(2, 0)
    logits = np.array([[0.5, 1.0, 1.0, 1.0], [2.0, 2.0, 0.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0]], np.float32)
    jw, jids, jaux = JM._topk_route(jnp.asarray(logits), jcfg.moe)
    w, ids, aux = M.topk_route(torch.from_numpy(logits), cfg.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy(), [[1, 2], [0, 1], [0, 1]])
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_expert_ranks_are_stable():
    ids = np.random.default_rng(2).integers(0, 5, 200).astype(np.int32)
    ref = np.asarray(JM._expert_ranks(jnp.asarray(ids), 5))
    got = M.expert_ranks(torch.from_numpy(ids.astype(np.int64)), 5).numpy()
    np.testing.assert_array_equal(got, ref)
    for e in range(5):                       # 0, 1, 2, ... in token order
        np.testing.assert_array_equal(got[ids == e], np.arange((ids == e).sum()))


def test_bf16_moe_at_bf16_tolerance():
    """bf16 weights and input: y within 2e-2 (the reference kernel tests'
    bf16 tolerance), y bf16, the router fp32."""
    jcfg, cfg = _cfgs(2, 1)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16", param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    jp = JM.init_moe(jax.random.PRNGKey(4), jcfg, jnp.bfloat16)
    p = _convert(jax.tree.map(np.asarray, pvalues(jp)), "cpu")
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ref = JM.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    out = M.moe_forward(p, torch.from_numpy(x).bfloat16(), cfg)
    assert out.y.dtype == torch.bfloat16
    scale = float(np.abs(_np(ref.y)).max())
    np.testing.assert_allclose(_np(out.y), _np(ref.y), atol=2e-2 * scale, rtol=2e-2)


# ---------------------------------------------------------------------------
# reduced llama4-scout as a whole: GQA attention + MoE with a shared expert
# ---------------------------------------------------------------------------

from repro.models import model as JMD                               # noqa: E402
from repro.models.layers import with_values                         # noqa: E402
from repro_torch.configs import TrainConfig                         # noqa: E402
from repro_torch.models import model as MD                          # noqa: E402
from repro_torch.models.convert import params_from_jax              # noqa: E402
from repro_torch.train import step as TS                            # noqa: E402
from repro_torch.tree import tree_leaves, tree_map                  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
BF16_ULP = 2.0 ** -7
LOGIT_FLOOR = 1e-5      # the experts' 1/sqrt(E) scale lifts the residual stream


def _model(seed=0):
    upd = dict(dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **upd)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **upd)
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    rng = np.random.default_rng(seed + 100)
    for blk in (vals["segments"][0], vals):
        for k in ("ln1", "ln2", "final_norm"):
            if k in blk:
                blk[k]["scale"] = (1.0 + 0.3 * rng.standard_normal(
                    blk[k]["scale"].shape)).astype(np.float32)
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    return jcfg, cfg, jparams, params_from_jax(vals, cfg, device="cpu")


def test_llama4_loss_and_grads_match():
    """Loss, ce and aux, and every grad against ``jax.grad`` (rtol 1e-4,
    atol 1e-5 × max(1, the leaf's largest |grad|))."""
    jcfg, cfg, jparams, params = _model()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}, remat="none"),
        has_aux=True)(jparams)
    loss, m, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(
        params, {"tokens": torch.from_numpy(toks)})
    for k in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(m["aux"]) > 0
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jg)), cfg, device="cpu")
    assert len(tree_leaves(grads)) == len(tree_leaves(ref))

    def close(a, b):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(b).max())))
    tree_map(close, grads, ref)


def test_llama4_prefill_and_decode_match():
    """Prefill (the MoE over B·T tokens) and T decode steps (over B tokens,
    at the config's capacity factor: a step's capacity is ceil(1.25·B·k/E))
    against the reference's, logits within one bf16 ulp and caches within
    1e-4."""
    jcfg, cfg, jparams, params = _model(seed=2)
    T = 10
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    jl, _, _ = JMD.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    pl, _ = MD.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(pl), _np(jl), rtol=BF16_ULP, atol=LOGIT_FLOOR)
    jc = JMD.init_decode_caches(jcfg, B, T, dtype=jnp.float32)
    c = MD.init_decode_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    for pos in range(T):
        jd, jc = JMD.decode_step(jparams, jcfg, jc, jnp.asarray(toks[:, pos:pos + 1]), pos)
        dd, c = MD.decode_step(params, cfg, c, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(_np(dd), _np(jd), rtol=BF16_ULP, atol=LOGIT_FLOOR)
    for a, b in zip(tree_leaves(list(c)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)
