"""Port parity for the SSM slice: the SSD scan's plain version, the Mamba2
block and reduced mamba2-370m through the reference package and the port.

Inputs are drawn with numpy from a seed and handed to both packages. The
reference is called un-jitted and outside any mesh.

Tolerances:
- ``ssd_plain`` vs ``ssd_reference`` (the same algorithm and dtype flow):
  fp32 atol = rtol = 1e-5 (fp32 sums in other orders); bf16 atol = rtol =
  1e-2, a bf16 ulp of |y| ~ 2 (y is bf16; the C·Bᵀ product rounds to bf16
  in both, after fp32 sums in other orders).
- ``ssd_plain`` vs the Pallas kernel in interpret mode: the reference's own
  kernel tolerances (``tests/test_kernels.py``), atol 5e-4 in fp32 and 5e-2
  in bf16; in bf16 the kernel keeps C·Bᵀ and the carried state in fp32
  where ``ssd_reference`` rounds them to bf16.
- Gradients, the block and the reduced model in fp32: atol 1e-5, rtol 1e-4
  (grads) and 1e-4 (hidden states and caches); logits are bf16 and agree
  within one bf16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import model as JMD
from repro.models import ssm as JS
from repro.models.layers import pvalues, with_values
from repro.train import step as JTS
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist.compression import init_error_feedback
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.ssd_scan import ssd_plain
from repro_torch.models import model as MD
from repro_torch.models import ssm as S
from repro_torch.models.convert import _convert, params_from_jax
from repro_torch.optim import make_optimizer
from repro_torch.train import step as TS
from repro_torch.tree import reference_leaves, tree_leaves, tree_map

SSD_CASES = [  # tests/test_kernels.py: b, l, h, p, g, n, chunk
    (1, 128, 2, 16, 1, 8, 32),
    (2, 64, 4, 8, 2, 16, 16),
    (1, 256, 8, 16, 1, 32, 64),
    (1, 32, 2, 8, 1, 8, 32),         # single chunk
]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
REF_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
KERNEL_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
HIDDEN_TOL = 1e-4
BF16_ULP = 2.0 ** -7
LOGIT_FLOOR = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ssd_inputs(case, seed=0):
    """x, dt, A, B, C, D as fp32 numpy, scaled as the reference's tests."""
    b, l, h, p, g, n, _ = case
    r = np.random.default_rng(seed)
    return ((r.standard_normal((b, l, h, p)) * 0.5).astype(np.float32),
            (np.log1p(np.exp(r.standard_normal((b, l, h)))) * 0.2).astype(np.float32),
            (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32),
            (r.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
            (r.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
            (1.0 + 0.5 * r.standard_normal(h)).astype(np.float32))


def _both(arrays, dname):
    """(jax arrays, torch tensors) with x, B, C in ``dname``; dt, A, D fp32."""
    np_dt, t_dt = DTYPES[dname]
    cast = {0, 3, 4}
    jx = [jnp.asarray(a.astype(np_dt) if i in cast else a)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).to(t_dt) if i in cast else torch.from_numpy(a)
          for i, a in enumerate(arrays)]
    return jx, tx


# ---------------------------------------------------------------------------
# The SSD scan's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_reference(case, dname):
    jx, tx = _both(_ssd_inputs(case), dname)
    chunk = case[-1]
    yr, sr = JS.ssd_reference(*jx, chunk=chunk, return_state=True)
    y, st = ssd_plain(*tx, chunk=chunk, return_state=True)
    assert y.dtype == st.dtype == DTYPES[dname][1]
    tol = REF_TOL[dname]
    np.testing.assert_allclose(_np(y), _np(yr), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(st), _np(sr), atol=tol, rtol=tol)
    y_only = ssd_plain(*tx, chunk=chunk)
    assert torch.equal(y_only, y)
    y_ops, st_ops = ops.ssd_chunked(*tx, chunk=chunk)      # CPU: plain version
    assert torch.equal(y_ops, y) and torch.equal(st_ops, st)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_pallas_interpret(case, dname):
    jx, tx = _both(_ssd_inputs(case, seed=1), dname)
    chunk = case[-1]
    yk, sk = pallas_ssd_scan(*jx, chunk=chunk, interpret=True)
    y, st = ssd_plain(*tx, chunk=chunk, return_state=True)
    tol = KERNEL_TOL[dname]
    np.testing.assert_allclose(_np(y), _np(yk), atol=tol)
    np.testing.assert_allclose(_np(st), _np(sk), atol=tol)


def test_ssd_plain_initial_state_matches_reference():
    case = SSD_CASES[1]
    arrays = _ssd_inputs(case, seed=2)
    b, _, h, p, _, n, chunk = case
    h0 = (np.random.default_rng(3).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    jx, tx = _both(arrays, "float32")
    yr, sr = JS.ssd_reference(*jx, chunk=chunk, h0=jnp.asarray(h0),
                              return_state=True)
    y, st = ssd_plain(*tx, chunk=chunk, h0=torch.from_numpy(h0),
                      return_state=True)
    np.testing.assert_allclose(_np(y), _np(yr), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(st), _np(sr), atol=1e-5, rtol=1e-5)


def test_ssd_chunk_invariance():
    """As the reference's property test: the result does not depend on the
    chunk size."""
    arrays = list(_ssd_inputs((1, 128, 2, 8, 1, 8, 0), seed=4))
    arrays[5] = np.zeros_like(arrays[5])
    _, tx = _both(arrays, "float32")
    outs = [R.ssd_ref(*tx, chunk=c) for c in (16, 32, 64, 128)]
    for y, st in outs[1:]:
        np.testing.assert_allclose(_np(y), _np(outs[0][0]), atol=1e-4)
        np.testing.assert_allclose(_np(st), _np(outs[0][1]), atol=1e-4)


@pytest.mark.parametrize("case", [SSD_CASES[0], SSD_CASES[1]])
def test_ssd_plain_grads_match_jax(case):
    """Grads of <y, gy> + <state, gs> w.r.t. x, dt, A, B, C, D."""
    arrays = _ssd_inputs(case, seed=5)
    b, l, h, p, g, n, chunk = case
    r = np.random.default_rng(6)
    gy = r.standard_normal((b, l, h, p)).astype(np.float32)
    gs = r.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(*xs):
        y, st = JS.ssd_reference(*xs, chunk=chunk, return_state=True)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, st = ssd_plain(*tx, chunk=chunk, return_state=True)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                                + (st * torch.from_numpy(gs)).sum(), tx)
    for name, a, ref in zip(("x", "dt", "A", "B", "C", "D"), grads, jgrads):
        np.testing.assert_allclose(_np(a), _np(ref), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# The Mamba2 block's pieces
# ---------------------------------------------------------------------------

def _cfgs(fp32=True):
    upd = dict(dtype="float32", param_dtype="float32") if fp32 else {}
    return (dataclasses.replace(jax_reduced(jax_get_config("mamba2-370m")), **upd),
            dataclasses.replace(reduced(get_config("mamba2-370m")), **upd))


def test_reduced_config_matches_reference():
    jcfg, cfg = _cfgs(fp32=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config("mamba2-370m")) == dataclasses.asdict(
        jax_get_config("mamba2-370m"))
    s, d_in, nh, conv_dim = S._dims(cfg)
    assert (cfg.n_layers, cfg.d_model, nh, s.head_dim, s.d_state, s.chunk_size) == (
        2, 64, 8, 16, 16, 32)
    assert S._dims(cfg)[1:] == JS._dims(jcfg)[1:]


def test_ssd_decode_step_matches():
    r = np.random.default_rng(7)
    b, h, p, g, n = 2, 4, 8, 2, 16
    state = r.standard_normal((b, h, p, n)).astype(np.float32)
    x = r.standard_normal((b, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal((b, h)))) * 0.2).astype(np.float32)
    A = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    B = r.standard_normal((b, g, n)).astype(np.float32)
    C = r.standard_normal((b, g, n)).astype(np.float32)
    D = r.standard_normal(h).astype(np.float32)
    args = (state, x, dt, A, B, C, D)
    yr, sr = JS.ssd_decode_step(*map(jnp.asarray, args))
    y, st = S.ssd_decode_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(y), _np(yr), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(st), _np(sr), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    r = np.random.default_rng(8)
    Bn, L, Ch, K = 2, 5, 12, 4
    x = r.standard_normal((Bn, L, Ch)).astype(np.float32)
    w = r.standard_normal((K, Ch)).astype(np.float32)
    bias = r.standard_normal(Ch).astype(np.float32)
    state = r.standard_normal((Bn, K - 1, Ch)).astype(np.float32) if with_state else None
    yr, tr = JS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                            None if state is None else jnp.asarray(state))
    y, tail = S.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(bias),
                            None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(_np(y), _np(yr), atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(_np(tail), _np(tr))


def test_gated_norm_matches():
    r = np.random.default_rng(9)
    y, z = (r.standard_normal((2, 3, 32)).astype(np.float32) for _ in range(2))
    scale = (1.0 + 0.3 * r.standard_normal(32)).astype(np.float32)
    ref = JS._gated_norm(jnp.asarray(scale), jnp.asarray(y), jnp.asarray(z), 1e-6)
    out = S._gated_norm(torch.from_numpy(scale), torch.from_numpy(y),
                        torch.from_numpy(z), 1e-6)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)


def _seeded_block(jcfg, seed):
    """The reference's Mamba2 init with its zero/one leaves replaced by seeded
    values, as (reference Param tree, numpy values)."""
    jp = JS.init_mamba2(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    vals = jax.tree.map(np.asarray, pvalues(jp))
    r = np.random.default_rng(seed + 100)
    for name, loc in (("conv_b", 0.0), ("D", 1.0), ("norm_scale", 1.0)):
        vals[name] = (loc + 0.3 * r.standard_normal(vals[name].shape)).astype(np.float32)
    return with_values(jp, jax.tree.map(jnp.asarray, vals)), vals


@pytest.mark.parametrize("mode", ["chunked_padded", "decode"])
def test_mamba2_forward_matches(mode):
    jcfg, cfg = _cfgs()
    jp, vals = _seeded_block(jcfg, 10)
    params = _convert(vals, "cpu")
    r = np.random.default_rng(11)
    s, d_in, nh, conv_dim = S._dims(cfg)
    Bn = 2
    if mode == "decode":
        x = r.standard_normal((Bn, 1, cfg.d_model)).astype(np.float32)
        conv = r.standard_normal((Bn, s.d_conv - 1, conv_dim)).astype(np.float32)
        ssd = r.standard_normal((Bn, nh, s.head_dim, s.d_state)).astype(np.float32)
        jcache = (jnp.asarray(conv), jnp.asarray(ssd))
        cache = (torch.from_numpy(conv), torch.from_numpy(ssd))
    else:   # 40 steps: two chunks of 32, the second padded
        x = r.standard_normal((Bn, 40, cfg.d_model)).astype(np.float32)
        jcache = cache = None
    yr, (tr, sr) = JS.mamba2_forward(jp, jnp.asarray(x), jcfg, jcache)
    y, (tail, st) = S.mamba2_forward(params, torch.from_numpy(x), cfg, cache)
    np.testing.assert_allclose(_np(y), _np(yr), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    np.testing.assert_allclose(_np(tail), _np(tr), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    np.testing.assert_allclose(_np(st), _np(sr), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)


# ---------------------------------------------------------------------------
# Reduced mamba2-370m as a whole
# ---------------------------------------------------------------------------

def _params(jcfg, cfg, seed=0):
    """Reference init with the zero/one leaves (norm scales, conv_b, D) made
    seeded values; the same weights in both packages."""
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    r = np.random.default_rng(seed + 100)

    def like(a, loc):
        return (loc + 0.3 * r.standard_normal(a.shape)).astype(a.dtype)

    seg = vals["segments"][0]
    seg["ln"]["scale"] = like(seg["ln"]["scale"], 1.0)
    for name, loc in (("conv_b", 0.0), ("D", 1.0), ("norm_scale", 1.0)):
        seg["mamba"][name] = like(seg["mamba"][name], loc)
    vals["final_norm"]["scale"] = like(vals["final_norm"]["scale"], 1.0)
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    return jparams, vals, params_from_jax(vals, cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def test_convert_keeps_depthwise_conv_layout():
    jcfg, cfg = _cfgs(fp32=False)
    _, vals, params = _params(jcfg, cfg)
    s, d_in, nh, conv_dim = S._dims(cfg)
    seg = vals["segments"][0]["mamba"]
    for i, blk in enumerate(params["segments"][0]):
        m = blk["mamba"]
        assert tuple(m["conv_w"].shape) == (s.d_conv, conv_dim)
        np.testing.assert_array_equal(_np(m["conv_w"]), seg["conv_w"][i].astype(np.float32))
        np.testing.assert_array_equal(_np(m["in_proj"]["weight"]),
                                      seg["in_proj"]["kernel"][i].astype(np.float32).T)
        for name in ("conv_b", "A_log", "D", "dt_bias", "norm_scale"):
            np.testing.assert_array_equal(_np(m[name]), seg[name][i].astype(np.float32))
        assert m["A_log"].dtype == m["D"].dtype == torch.float32
        assert m["conv_w"].dtype == torch.bfloat16
    # the port's own init has the same structure, shapes and dtypes (dict
    # entries matched by key: the reference's tree comes back key-sorted)
    own = MD.init_model(cfg, seed=0, device="cpu")
    assert len(tree_leaves(own)) == len(tree_leaves(params))
    tree_map(lambda a, b: (a.shape, a.dtype) == (b.shape, b.dtype) or pytest.fail(
        f"{tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}"), own, params)


def test_reference_leaves_group_the_layers():
    """9 tensors per layer, stacked into the reference's 9 leaves, plus the
    embedding and the final norm."""
    _, cfg = _cfgs(fp32=False)
    cfg = dataclasses.replace(cfg, n_layers=5)
    params = MD.init_model(cfg, seed=0, device="cpu")
    groups = reference_leaves(params)
    assert len(groups) == 11
    assert sorted(len(idx) for _, idx in groups) == [1, 1] + [5] * 9
    assert sum(len(idx) for _, idx in groups) == len(tree_leaves(params)) == 47


def test_loss_and_grads_match():
    jcfg, cfg = _cfgs()
    jparams, _, params = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 40), 1)               # two chunks, padded
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)},
                              remat="none"), has_aux=True)(jparams)
    loss, metrics, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(metrics["tokens"]) == 2 * 39
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jgrads)), cfg, device="cpu")
    tree_map(lambda a, b: np.testing.assert_allclose(
        _np(a), _np(b), atol=GRAD_ATOL, rtol=GRAD_RTOL), grads, ref)
    # remat full recomputes the same grads
    _, _, g_full = TS._grad_fn(cfg, TrainConfig(remat_policy="full"))(
        params, {"tokens": torch.from_numpy(toks)})
    for a, b in zip(tree_leaves(grads), tree_leaves(g_full)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_train_step_adamw_int8_ef_matches():
    """One adamw step through the codec, one scale per reference leaf:
    loss and grad norm as the reference's; params within two lr of it (an
    element whose grad lands on the other side of a rounding boundary of
    the codec moves by up to ~lr in adamw's first step)."""
    jcfg, cfg = _cfgs()
    kw = dict(optimizer="adamw", grad_compression="int8_ef",
              remat_policy="none", warmup_steps=1, total_steps=4)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jparams, _, params = _params(jcfg, cfg)
    jstate = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)._replace(
        params=jparams)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    state = TS.TrainState(params, opt_init(params, tcfg), init_error_feedback(params))
    toks = _tokens(cfg, (2, 32), 12)
    jnew, jm = JTS.make_train_step(jcfg, jtcfg)(jstate, {"tokens": jnp.asarray(toks)})
    new, m = TS.make_train_step(cfg, tcfg)(state, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    ref = params_from_jax(jax.tree.map(np.asarray, pvalues(jnew.params)), cfg,
                          device="cpu")
    lr = float(jm["lr"])
    moved = 0
    for a, b in zip(tree_leaves(new.params), tree_leaves(ref)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2 * lr + 1e-6, rtol=0)
        moved += int((np.abs(_np(a) - _np(b)) > 1e-5).sum())
    total = sum(t.numel() for t in tree_leaves(ref))
    assert moved <= total * 1e-3, (moved, total)


def test_decode_loop_matches_full_forward_and_prefill_caches():
    """As tests/test_serve.py: the decode loop's last logits against the
    full forward's, and MD.prefill's caches (conv tails and final SSD
    states, 12 steps padded to a chunk of 32) against the decode loop's."""
    jcfg, cfg = _cfgs()
    _, _, params = _params(jcfg, cfg)
    Bn, T = 2, 12
    toks = torch.from_numpy(_tokens(cfg, (Bn, T), 2))
    caches = MD.init_decode_caches(cfg, Bn, T, dtype=torch.float32, device="cpu")
    assert caches[0][1].dtype == torch.float32
    with torch.inference_mode():
        for pos in range(T):
            logits, caches = MD.decode_step(params, cfg, caches,
                                            toks[:, pos:pos + 1], pos)
        pre, pcaches = MD.prefill(params, cfg, {"tokens": toks})
    np.testing.assert_allclose(_np(logits), _np(pre), atol=5e-3, rtol=5e-3)
    for got, want in zip(pcaches[0], caches[0]):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL)


def test_decode_and_prefill_match_reference():
    """Port vs reference: decode-step logits within one bf16 ulp and the
    SSM caches after 12 steps; prefill logits and caches."""
    jcfg, cfg = _cfgs()
    jparams, _, params = _params(jcfg, cfg)
    Bn, T = 2, 12
    toks = _tokens(cfg, (Bn, T), 3)
    jcaches = JMD.init_decode_caches(jcfg, Bn, T, dtype=jnp.float32)
    caches = MD.init_decode_caches(cfg, Bn, T, dtype=torch.float32, device="cpu")
    for pos in range(T):
        jlogits, jcaches = JMD.decode_step(jparams, jcfg, jcaches,
                                           jnp.asarray(toks[:, pos:pos + 1]), pos)
        logits, caches = MD.decode_step(params, cfg, caches,
                                        torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert logits.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=BF16_ULP,
                                   atol=LOGIT_FLOOR, err_msg=f"step {pos}")
    for got, want in zip(caches[0], jcaches[0]):
        np.testing.assert_allclose(_np(got), _np(want), atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL)
    jpre, jpc, _ = JMD.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    pre, pc = MD.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(pre), _np(jpre), rtol=BF16_ULP, atol=LOGIT_FLOOR)
    for got, want in zip(pc[0], jpc[0]):
        np.testing.assert_allclose(_np(got), _np(want), atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL)
