"""Port parity for every LM MLP activation, reduced nemotron-4-15b (sqrelu,
a non-gated MLP, an untied head), the fp32 logits under a final softcap,
remat "dots", and the train step's in-place update.

Inputs are drawn with numpy and handed to both packages. Tolerances: fp32
within atol = rtol = 1e-5 for one MLP, the loss within 1e-5 relative and
grads within atol 1e-5, rtol 1e-4 (as ``test_torch_train.py``); bf16 MLP
outputs at 2e-2; logits within one bf16 ulp. remat "dots" is held bit for
bit against the port's own "none" on the CPU, where recomputation changes
no arithmetic.
"""
import collections
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JMD
from repro.models.layers import pvalues, with_values
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.train import step as TS
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BF16_ULP = 2.0 ** -7
ACTIVATIONS = ["silu", "geglu", "gelu", "relu", "sqrelu", "tanh"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mlp_matches_reference(activation, dtype):
    """``mlp`` and ``init_mlp`` for every activation of the reference's
    ``activation_fn`` that an LM config names: gated (silu, geglu) or not,
    gelu the tanh approximation (``jax.nn.gelu``'s default)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jparams = JL.init_mlp(jax.random.PRNGKey(3), 32, 48, activation, jdt)
    jp = pvalues(jparams)
    gen = torch.Generator().manual_seed(0)
    port_init = L.init_mlp(gen, 32, 48, activation, tdt)
    assert sorted(port_init) == sorted(jp)
    assert ("gate" in jp) == (activation in L.GATED)
    params = {k: {"weight": torch.from_numpy(np.asarray(v["kernel"], np.float32).T
                                             .copy()).to(tdt)}
              for k, v in jp.items()}
    for k, v in params.items():
        assert v["weight"].shape == port_init[k]["weight"].shape
    x = (np.random.default_rng(1).standard_normal((2, 5, 32)) * 2.0).astype(np.float32)
    ref = JL.mlp(jparams, jnp.asarray(x, jdt), activation)
    out = L.mlp(params, torch.from_numpy(x).to(tdt), activation)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        L.activation_fn("swish")


def test_nemotron_loss_and_grads_match():
    """Reduced nemotron-4-15b in fp32: sqrelu without a gate, an untied
    lm_head; loss and every grad against ``jax.grad``. The squared
    activations make some leaves' grads O(1) (the embedding's up to ~2,
    smollm's stay below 0.2), so each leaf's absolute tolerance is 1e-5
    times its largest grad, at least 1e-5."""
    upd = dict(dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("nemotron-4-15b")), **upd)
    cfg = dataclasses.replace(reduced(get_config("nemotron-4-15b")), **upd)
    jparams = JMD.init_model(jax.random.PRNGKey(0), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    rng = np.random.default_rng(7)
    seg = vals["segments"][0]
    for ln in ("ln1", "ln2"):
        seg[ln]["scale"] = (1 + 0.3 * rng.standard_normal(seg[ln]["scale"].shape)
                            ).astype(np.float32)
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    params = params_from_jax(vals, cfg, device="cpu")
    assert "gate" not in params["segments"][0][0]["mlp"] and "lm_head" in params
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)

    def loss_for(p):
        return JMD.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}, remat="none")
    (jloss, _), jgrads = jax.value_and_grad(loss_for, has_aux=True)(jparams)
    loss, _, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jgrads)), cfg, device="cpu")
    tree_map(lambda a, b: np.testing.assert_allclose(
        _np(a), _np(b), atol=1e-5 * max(1.0, float(np.abs(_np(b)).max())),
        rtol=1e-4), grads, ref)


# ---------------------------------------------------------------------------
# The logits under a final softcap
# ---------------------------------------------------------------------------

def test_bf16_logits_under_final_softcap_match_reference():
    """bf16 h [64, 256] and table [4096, 256], final softcap 30: the
    reference takes the product in fp32, softcaps, then casts to bf16. The
    port's ``logits_fn`` agrees but for summation order (a few values in
    10^4, one ulp each, or 1e-6 for values near zero); a bf16 product
    rounded before the softcap, what the port computed before, misses about
    one value in six."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((64, 256)).astype(np.float32)
    table = (rng.standard_normal((4096, 256)) * 0.1).astype(np.float32)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma2-2b")),
                               d_model=256, vocab_size=4096)
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")),
                              d_model=256, vocab_size=4096)
    assert cfg.final_logit_softcap == 30.0 and cfg.tie_embeddings
    jh, jt = jnp.asarray(h, jnp.bfloat16), jnp.asarray(table, jnp.bfloat16)
    ref = _np(JMD.logits_fn({"embed": {"table": JL.Param(jt, ("vocab", "embed"))}},
                            jcfg, jh))
    th, tt = torch.from_numpy(h).bfloat16(), torch.from_numpy(table).bfloat16()
    out = MD.logits_fn({"embed": {"table": tt}}, cfg, th)
    assert out.dtype == torch.bfloat16
    out = _np(out)
    differ = np.mean(out != ref)
    assert differ < 1e-3, differ
    np.testing.assert_allclose(out, ref, rtol=BF16_ULP, atol=1e-6)
    rounded_first = _np(L.softcap(torch.nn.functional.linear(th, tt).float(), 30.0)
                        .bfloat16())
    assert np.mean(rounded_first != ref) > 0.1


def test_unembed_backward_is_the_bf16_product_backward():
    """The fp32-output product's grads are those of a bf16 product
    followed by a cast to fp32 (the cotangent rounded to bf16 first)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32)).bfloat16()
    t = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((3, 4, 40)).astype(np.float32))
    xa, ta = x.clone().requires_grad_(True), t.clone().requires_grad_(True)
    got = torch.autograd.grad(L.unembed({"table": ta}, xa), (xa, ta), g)
    xb, tb = x.clone().requires_grad_(True), t.clone().requires_grad_(True)
    want = torch.autograd.grad(torch.nn.functional.linear(xb, tb).float(), (xb, tb), g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# remat "dots"
# ---------------------------------------------------------------------------

REMAT_ARCHS = {"gemma2-2b": {"n_layers": 4}, "whisper-tiny": {}}


def _reduced(arch, dtype="float32", lib=None):
    upd = dict(REMAT_ARCHS[arch], dtype=dtype, param_dtype=dtype)
    if lib == "jax":
        return dataclasses.replace(jax_reduced(jax_get_config(arch)), **upd)
    return dataclasses.replace(reduced(get_config(arch)), **upd)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _grads(params, cfg, batch, remat, count=False):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = MD.loss_fn(tree_unflatten(params, leaves), cfg, batch, remat=remat)
    mode = _CountOps()
    with mode if count else contextlib.nullcontext():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss, grads, mode.counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
def test_remat_dots_grads_bit_equal_to_none(arch, dtype):
    cfg = _reduced(arch, dtype)
    params = MD.init_model(cfg, seed=0, device="cpu")
    batch = make_batch_for(cfg, 2, 16)
    loss0, g0, _ = _grads(params, cfg, batch, "none")
    loss1, g1, _ = _grads(params, cfg, batch, "dots")
    assert float(loss0.detach()) == float(loss1.detach())
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
def test_remat_dots_backward_reruns_no_dense_product(arch):
    """Under "dots" the backward runs exactly the dense products of the
    "none" backward (the forward's are kept); under "full" it reruns the
    forward's as well. The attention's batched products are recomputed
    under both."""
    cfg = _reduced(arch)
    params = MD.init_model(cfg, seed=0, device="cpu")
    batch = make_batch_for(cfg, 2, 16)
    dense = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    counts = {r: _grads(params, cfg, batch, r, count=True)[2]
              for r in ("none", "dots", "full")}
    n = {r: sum(c[op] for op in dense) for r, c in counts.items()}
    bmm = {r: c[torch.ops.aten.bmm.default] for r, c in counts.items()}
    assert n["dots"] == n["none"] > 0
    assert n["full"] > n["none"]
    assert bmm["dots"] == bmm["full"] > bmm["none"]


@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
def test_remat_dots_grads_match_reference_dots(arch):
    jcfg, cfg = _reduced(arch, lib="jax"), _reduced(arch)
    jparams = JMD.init_model(jax.random.PRNGKey(0), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    params = params_from_jax(vals, cfg, device="cpu")
    batch = make_batch_for(cfg, 2, 16)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def loss_for(p):
        return JMD.loss_fn(p, jcfg, jbatch, remat="dots")
    (jloss, _), jgrads = jax.value_and_grad(loss_for, has_aux=True)(jparams)
    loss, grads, _ = _grads(params, cfg, batch, "dots")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = tree_leaves(params_from_jax(jax.tree.map(np.asarray, pvalues(jgrads)),
                                      cfg, device="cpu"))
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The train step's in-place update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,compression", [("adamw", "int8_ef"),
                                                   ("sgd", "none"),
                                                   ("adafactor", "int8")])
def test_train_step_updates_state_in_place(optimizer, compression):
    """The step writes params, moments and residuals into the state's own
    tensors over two steps (its values are held to the reference's by the
    train-step parity tests) and every one of them moves."""
    cfg = _reduced("gemma2-2b")
    tcfg = TrainConfig(optimizer=optimizer, grad_compression=compression,
                       remat_policy="dots", warmup_steps=1, total_steps=4)
    state = TS.init_train_state(cfg, tcfg, seed=0, device="cpu")

    def state_tensors(st):
        return tree_leaves([t for t in (st.params, st.ef, st.opt.mu, st.opt.nu)
                            if t is not None])

    before = state_tensors(state)
    start = [t.clone() for t in before]
    step = TS.make_train_step(cfg, tcfg)
    for i in range(2):
        state, m = step(state, make_batch_for(cfg, 2, 16, step=i))
        assert np.isfinite(float(m["loss"]))
    assert state.opt.step == 2
    after = state_tensors(state)
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    assert all(not torch.equal(a, b) for a, b in zip(after, start))
