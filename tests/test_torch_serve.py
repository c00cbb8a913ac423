"""Port parity for the serving slice as a whole: reduced qwen2.5-3b through
the reference package and the port on the same weights.

Weights come from the reference's ``init_model``; its QKV biases and rmsnorm
scales (zeros and ones at init) are overwritten with seeded values first, so
a bias or norm bug cannot pass unseen. Two head layouts: the reduced
config's G = 2 and the full model's G = 8 (16 q heads over 2 kv heads).

``logits_fn`` casts logits to bf16 even in an fp32 config, so fp32 runs are
compared at two levels: the fp32 hidden states within atol = rtol = 1e-4,
and the bf16 logits within one bf16 ulp (rtol 2**-7), with an absolute
floor of 1e-6 for logits so close to zero that the cancellation error of
their fp32 sums (~1e-7) is larger than their bf16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMD
from repro.models.layers import pvalues, with_values
from repro.train.serve import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.train import serve as TS

BF16_ULP = 2.0 ** -7
HIDDEN_TOL = 1e-4
LOGIT_FLOOR = 1e-6
VARIANTS = {"g2": {}, "g8": {"n_heads": 16, "n_kv_heads": 2}}


def _cfgs(variant, fp32=True):
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"))
    cfg = reduced(get_config("qwen2.5-3b"))
    upd = dict(VARIANTS[variant])
    if fp32:
        upd.update(dtype="float32", param_dtype="float32")
    return dataclasses.replace(jcfg, **upd), dataclasses.replace(cfg, **upd)


def _params(jcfg, cfg, seed=0):
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    rng = np.random.default_rng(seed + 100)

    def like(a, loc, scale):
        return (loc + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    seg = vals["segments"][0]
    for name in ("wq", "wk", "wv"):
        seg["attn"][name]["bias"] = like(seg["attn"][name]["bias"], 0.0, 0.5)
    for ln in ("ln1", "ln2"):
        seg[ln]["scale"] = like(seg[ln]["scale"], 1.0, 0.3)
    vals["final_norm"]["scale"] = like(vals["final_norm"]["scale"], 1.0, 0.3)
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    return jparams, params_from_jax(vals, cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_ulp(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=BF16_ULP,
                               atol=LOGIT_FLOOR)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hidden_forward_and_prefill_match(variant):
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 12), 1)
    jpos = jnp.arange(12)
    jh, jcaches, _ = JMD.hidden_forward(
        jparams, jcfg, JMD.embed_tokens(jparams, jcfg, jnp.asarray(toks)),
        positions=jpos, keep_cache=True)
    h, caches, _ = MD.hidden_forward(
        params, cfg, MD.embed_tokens(params, cfg, torch.from_numpy(toks)),
        positions=torch.arange(12, dtype=torch.int32), keep_cache=True)
    np.testing.assert_allclose(_np(h), _np(jh), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    for port, ref in zip(caches[0], jcaches[0]):        # stacked k, v, pos
        np.testing.assert_allclose(_np(port), _np(ref), atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL)

    jlogits, _, _ = JMD.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits, _ = TS.make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    _assert_ulp(logits, jlogits)


def test_untied_lm_head_matches():
    """An untied config goes through the lm_head weight, not the table."""
    jcfg, cfg = _cfgs("g2")
    jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
    cfg = dataclasses.replace(cfg, tie_embeddings=False)
    jparams, params = _params(jcfg, cfg)
    assert params["lm_head"]["weight"].shape == (cfg.vocab_size, cfg.d_model)
    toks = _tokens(cfg, (2, 5), 7)
    jlogits, _, _ = JMD.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    logits, _ = MD.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    _assert_ulp(logits, jlogits)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match(variant):
    """12 decode steps with caches: per-step hidden states, then logits."""
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg)
    B, T = 2, 12
    toks = _tokens(cfg, (B, T), 2)
    jcaches = JMD.init_decode_caches(jcfg, B, T, dtype=jnp.float32)
    caches = MD.init_decode_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    for pos in range(T):
        jh, jcaches, _ = JMD.hidden_forward(
            jparams, jcfg, JMD.embed_tokens(jparams, jcfg, jnp.asarray(toks[:, pos:pos + 1])),
            positions=jnp.full((1,), pos, jnp.int32), caches=jcaches,
            cache_pos=pos, keep_cache=True)
        h, caches, _ = MD.hidden_forward(
            params, cfg, MD.embed_tokens(params, cfg, torch.from_numpy(toks[:, pos:pos + 1])),
            positions=torch.full((1,), pos, dtype=torch.int32), caches=caches,
            cache_pos=pos)
        np.testing.assert_allclose(_np(h), _np(jh), atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL, err_msg=f"step {pos}")

    jcaches = JMD.init_decode_caches(jcfg, B, T, dtype=jnp.float32)
    caches = MD.init_decode_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    step = TS.make_decode_step(cfg)
    for pos in range(T):
        jlogits, jcaches = JMD.decode_step(jparams, jcfg, jcaches,
                                           jnp.asarray(toks[:, pos:pos + 1]), pos)
        logits, caches = step(params, caches, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert logits.dtype == torch.bfloat16
        _assert_ulp(logits, jlogits)
    for port, ref in zip(caches[0], jcaches[0]):
        np.testing.assert_allclose(_np(port), _np(ref), atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL)


GREEDY_SEED = 6   # a seed whose greedy steps have no top-2 rounding tie


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_generate_tokens_identical(variant):
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg, seed=GREEDY_SEED)
    prompt = _tokens(cfg, (2, 6), GREEDY_SEED + 3)
    n_steps = 8
    ref = np.asarray(jax_greedy_generate(jparams, jcfg, jnp.asarray(prompt), n_steps))
    out = TS.greedy_generate(params, cfg, torch.from_numpy(prompt), n_steps)
    assert tuple(out.shape) == (2, n_steps)
    np.testing.assert_array_equal(out.numpy(), ref)

    # The comparison is only meaningful if no step is a rounding tie: redo
    # the reference's loop (bf16 caches, as greedy_generate keeps them) and
    # require the top-2 gap of every step's bf16 logits to exceed one ulp.
    B, S = prompt.shape
    caches = JMD.init_decode_caches(jcfg, B, S + n_steps)
    tok = None
    for pos in range(S + n_steps - 1):
        cur = jnp.asarray(prompt[:, pos:pos + 1]) if pos < S else tok
        logits, caches = JMD.decode_step(jparams, jcfg, caches, cur, pos)
        if pos >= S - 1:                  # steps whose argmax is a token
            top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
            gap = top2[:, 1] - top2[:, 0]
            assert (gap > BF16_ULP * np.abs(top2[:, 1])).all(), (pos, gap)
        tok = jnp.argmax(logits, axis=-1)[:, None]


def test_decode_bf16_matches_at_bf16_tolerance():
    """bf16 weights, activations and caches. The packages round bf16 at
    different places (XLA fuses ops and keeps some products in fp32 before
    one rounding; eager PyTorch rounds after every op, bias add included),
    so the logits (|x| < 0.7 here) differ by up to two bf16 ulps (7.8e-3 at
    this seed) after two layers. Compared at atol = rtol = 2e-2, the bf16
    tolerance of tests/test_kernels.py, with the greedy choice identical."""
    jcfg, cfg = _cfgs("g8", fp32=False)
    jparams, params = _params(jcfg, cfg)
    B, T = 2, 8
    toks = _tokens(cfg, (B, T), 4)
    jcaches = JMD.init_decode_caches(jcfg, B, T)
    caches = MD.init_decode_caches(cfg, B, T, device="cpu")
    for pos in range(T):
        jlogits, jcaches = JMD.decode_step(jparams, jcfg, jcaches,
                                           jnp.asarray(toks[:, pos:pos + 1]), pos)
        logits, caches = MD.decode_step(params, cfg, caches,
                                        torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert logits.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=2e-2, rtol=2e-2,
                                   err_msg=f"step {pos}")
        np.testing.assert_array_equal(_np(logits).argmax(-1), _np(jlogits).argmax(-1))
