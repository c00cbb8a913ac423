"""Port parity: the plain attention (the CUDA kernel's CPU counterpart) and
the GQA block with its ring cache, against the reference's interpret-mode
Pallas kernel and ``attend_naive``.

Inputs are drawn with numpy and cast to the working dtype inside each
framework; results are compared in fp32. Tolerances: fp32 2e-5 (summation
order); bf16 2e-2, as ``tests/test_kernels.py`` uses, because the bf16
output rounds at different places in the two frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JA
from repro.models import model as JMD
from repro.models.layers import Param, is_param, pvalues
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention as A
from repro_torch.models.convert import params_from_jax

FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap
    (1, 128, 128, 2, 2, 16, True, 0, 0.0),
    (2, 64, 192, 4, 2, 32, True, 0, 0.0),
    (1, 128, 128, 4, 1, 16, True, 32, 0.0),
    (1, 96, 96, 2, 2, 16, True, 0, 20.0),
    (2, 1, 256, 4, 2, 16, True, 0, 0.0),          # decode
    (1, 64, 64, 3, 1, 8, False, 0, 0.0),          # non-causal (encoder)
    (1, 80, 144, 6, 3, 24, True, 48, 30.0),       # window + softcap, ragged
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd), np.float32),
            rng.standard_normal((B, Skv, Hkv, hd), np.float32),
            rng.standard_normal((B, Skv, Hkv, hd), np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrays]
    pt = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    return jx, pt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_reference(case, dtype):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, Sq, Skv, Hq, Hkv, hd), dtype)
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    jspec = JA.AttnSpec(causal=causal, window=window, logit_softcap=cap)
    spec = A.AttnSpec(causal=causal, window=window, logit_softcap=cap)
    out = FA.attention_plain(q, k, v, torch.from_numpy(q_pos),
                             torch.from_numpy(kv_pos), spec)
    assert out.dtype == TORCH[dtype] and tuple(out.shape) == (B, Sq, Hq, hd)
    kern = jax_flash(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), jspec,
                     block_q=64, block_kv=64, interpret=True)
    naive = JA.attend_naive(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                            jspec)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(out), _f32(naive), atol=tol, rtol=tol)


def test_plain_attention_ring_cache_positions():
    """Out-of-order kv_pos (a wrapped ring buffer) masks as the reference."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 1, 64, 2, 2, 16), "float32")
    kv_pos = np.concatenate([np.arange(64, 96), np.arange(32, 64)]).astype(np.int32)
    q_pos = np.array([95], np.int32)
    jspec = JA.AttnSpec(causal=True, window=40)
    out = FA.attention_plain(q, k, v, torch.from_numpy(q_pos),
                             torch.from_numpy(kv_pos), A.AttnSpec(causal=True, window=40))
    kern = jax_flash(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), jspec,
                     block_q=32, block_kv=32, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(kern), atol=2e-5, rtol=2e-5)


def test_wholly_masked_row_is_mean_of_v():
    """A row with no attendable key yields mean(v), as attend_naive does."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 1, 16, 4, 2, 8), "float32")
    q_pos, kv_pos = np.array([0], np.int32), np.arange(1, 17, dtype=np.int32)
    out = FA.attention_plain(q, k, v, torch.from_numpy(q_pos),
                             torch.from_numpy(kv_pos), A.AttnSpec())
    naive = JA.attend_naive(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                            JA.AttnSpec())
    np.testing.assert_allclose(_f32(out), _f32(naive), atol=2e-5, rtol=2e-5)
    mean_v = v.mean(dim=1, keepdim=True).repeat_interleave(2, dim=2)
    np.testing.assert_allclose(_f32(out), _f32(mean_v), atol=2e-5, rtol=2e-5)


def test_ops_dispatch_cpu_is_plain():
    _, (q, k, v) = _both(_qkv(1, 4, 8, 4, 2, 8), "float32")
    pos = torch.arange(8, dtype=torch.int32)
    spec = A.AttnSpec()
    before = FA.LAUNCHES
    out = ops.attention(q, k, v, pos[4:], pos, spec)
    assert FA.LAUNCHES == before
    torch.testing.assert_close(out, FA.attention_plain(q, k, v, pos[4:], pos, spec),
                               atol=0, rtol=0)
    torch.testing.assert_close(out, attention_ref(q, k, v, pos[4:], pos, spec),
                               atol=0, rtol=0)


def _layer0(tree):
    return jax.tree.map(lambda p: Param(p.value[0], p.axes[1:]), tree,
                        is_leaf=is_param)


@pytest.mark.parametrize("n_heads,n_kv", [(None, None), (16, 2)])
def test_gqa_forward_ring_cache_matches_reference(n_heads, n_kv):
    """One decode step at a wrapped ring slot: output and updated cache."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2.5-3b")),
                               dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")),
                              dtype="float32", param_dtype="float32")
    if n_heads:
        jcfg = dataclasses.replace(jcfg, n_heads=n_heads, n_kv_heads=n_kv)
        cfg = dataclasses.replace(cfg, n_heads=n_heads, n_kv_heads=n_kv)
    jparams = JMD.init_model(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    vals = pvalues(jparams)
    attn = vals["segments"][0]["attn"]
    for name in ("wq", "wk", "wv"):   # the init's zero biases would hide a bias bug
        attn[name]["bias"] = jnp.asarray(
            rng.standard_normal(attn[name]["bias"].shape, np.float32) * 0.5)
    jattn = _layer0(jax.tree.map(lambda p, v: Param(v, p.axes),
                                 jparams["segments"][0]["attn"], attn,
                                 is_leaf=is_param))
    port = params_from_jax(jax.tree.map(np.asarray, vals), cfg, device="cpu")
    pattn = port["segments"][0][0]["attn"]

    B, cap, hd = 2, 8, cfg.get_head_dim()
    pos = 13                                    # slot 13 % 8 = 5, wrapped
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    ck = rng.standard_normal((B, cap, cfg.n_kv_heads, hd), np.float32)
    cv = rng.standard_normal((B, cap, cfg.n_kv_heads, hd), np.float32)
    cpos = np.array([8, 9, 10, 11, 12, 2 ** 30, 6, 7], np.int32)

    jy, (jck, jcv, jcpos) = JA.gqa_forward(
        jattn, jnp.asarray(x), jcfg, JA.AttnSpec(), jnp.array([pos], jnp.int32),
        cache=(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cpos)), cache_pos=pos)
    cache = tuple(torch.from_numpy(a.copy()) for a in (ck, cv, cpos))
    y, (pck, pcv, pcpos) = A.gqa_forward(
        pattn, torch.from_numpy(x), cfg, A.AttnSpec(),
        torch.tensor([pos], dtype=torch.int32), cache=cache, cache_pos=pos)
    assert pck is cache[0]                      # written in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pck.numpy(), np.asarray(jck), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pcv.numpy(), np.asarray(jcv), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(pcpos.numpy(), np.asarray(jcpos))
    assert pcpos[5] == pos


@pytest.mark.parametrize("case", [(2, 48, 48, 4, 2, 16, True, 0, 0.0),
                                  (1, 40, 72, 6, 3, 8, True, 24, 30.0)])
def test_plain_attention_grads_match_blockwise_reference(case):
    """The backward that the flash attention op recomputes is autograd through
    ``attention_plain``: held against ``jax.grad`` of the reference's
    ``attend_blockwise`` (block 16, so its checkpointed blocks run), fp32."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = case
    arrays = _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=4)
    go = np.random.default_rng(5).standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    jspec = JA.AttnSpec(causal=causal, window=window, logit_softcap=cap)

    def jloss(q, k, v):
        o = JA.attend_blockwise(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                jspec, block=16)
        return jnp.sum(o * jnp.asarray(go))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrays])
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = FA.attention_plain(*qkv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                             A.AttnSpec(causal=causal, window=window,
                                        logit_softcap=cap))
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(go))
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(_f32(g), _f32(jg), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, True)])
def test_flash_function_backward_recomputes_plain(need):
    """The ``repro_torch::flash_attention`` op (``FA.attention``) on the CPU,
    where its implementation is the plain version: its forward is
    ``attention_plain``'s, its grads are autograd's through
    ``attention_plain``, and None for inputs that need none."""
    arrays = _qkv(2, 12, 12, 6, 2, 8, seed=6)
    go = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 12, 6, 8)).astype(np.float32))
    pos = torch.arange(12, dtype=torch.int32)
    spec = A.AttnSpec(causal=True)
    a = [torch.from_numpy(x).requires_grad_(n) for x, n in zip(arrays, need)]
    b = [torch.from_numpy(x).requires_grad_(n) for x, n in zip(arrays, need)]
    before = FA.LAUNCHES
    out = FA.attention(*a, pos, pos, spec)
    ref = FA.attention_plain(*b, pos, pos, spec)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    (out * go).sum().backward()
    (ref * go).sum().backward()
    for x, y, n in zip(a, b, need):
        if n:
            torch.testing.assert_close(x.grad, y.grad, atol=0, rtol=0)
        else:
            assert x.grad is None
    assert FA.LAUNCHES == before
