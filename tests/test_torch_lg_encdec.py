"""Port parity for the local/global pair (reduced gemma2-2b) and the
encoder-decoder kinds (reduced whisper-tiny): the reference package and the
port on the same weights, tokens and frames.

Weights come from the reference's ``init_model`` with every rmsnorm scale
(ones at init) overwritten by seeded values, so a norm bug cannot pass
unseen. gemma2 runs at 4 layers (2 pairs) with a window of 8, so the local
blocks' window bites within 12 tokens and their decode ring (8 slots)
evicts; two head layouts, 4 q over 4 kv heads and 4 over 2. whisper runs
its reduced 2 + 2 layers over 16 stub frames.

Tolerances are those of ``test_torch_serve.py`` and ``test_torch_train.py``:
fp32 hidden states and caches within 1e-4, bf16 logits within one bf16 ulp
(floor 1e-6), the loss within 1e-5 relative, grads within atol 1e-5 and
rtol 1e-4, two adamw steps' params within 1e-5; the bf16 cases at 2e-2.
The reference is called un-jitted, so that its codec divides by 127.
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
from repro.data import make_batch_for as jax_make_batch_for
from repro.dist import compression as JC
from repro.models import model as JMD
from repro.models.layers import pvalues, with_values
from repro.train import step as JTS
from repro.train.serve import greedy_generate as jax_greedy_generate
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.dist import compression as C
from repro_torch.dist.compression import init_error_feedback
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import make_optimizer
from repro_torch.train import serve as TSV
from repro_torch.train import step as TS
from repro_torch.tree import reference_leaves, tree_leaves, tree_map

BF16_ULP = 2.0 ** -7
HIDDEN_TOL = 1e-4
LOGIT_FLOOR = 1e-6
VARIANTS = {                 # (arch, config changes)
    "gemma2_h4kv4": ("gemma2-2b", {"n_layers": 4, "attn_window": 8}),
    "gemma2_h4kv2": ("gemma2-2b", {"n_layers": 4, "attn_window": 8,
                                   "n_kv_heads": 2}),
    "whisper": ("whisper-tiny", {}),
}
B, T = 2, 12


def _cfgs(variant, fp32=True):
    arch, upd = VARIANTS[variant]
    upd = dict(upd)
    if fp32:
        upd.update(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **upd),
            dataclasses.replace(reduced(get_config(arch)), **upd))


def _perturb_scales(tree, rng):
    """Every rmsnorm scale of a numpy values tree to 1 + 0.3 N(0, 1)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_scales(v, rng)
        elif isinstance(v, list):
            for x in v:
                _perturb_scales(x, rng)
        elif k == "scale":
            tree[k] = (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)


def _params(jcfg, cfg, seed=0):
    jparams = JMD.init_model(jax.random.PRNGKey(seed), jcfg)
    vals = jax.tree.map(np.asarray, pvalues(jparams))
    _perturb_scales(vals, np.random.default_rng(seed + 100))
    jparams = with_values(jparams, jax.tree.map(jnp.asarray, vals))
    return jparams, params_from_jax(vals, cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _frames(cfg, b, seed):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model)) * 0.5).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_ulp(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=BF16_ULP,
                               atol=LOGIT_FLOOR)


def _assert_nested_close(port, ref, tol):
    """Caches: nested tuples (an lg_pair's local and global) of tensors."""
    if isinstance(port, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_nested_close(p, r, tol)
        return
    np.testing.assert_allclose(_np(port), _np(ref), atol=tol, rtol=tol)


def _enc_kv(jparams, jcfg, params, cfg, frames):
    """Both packages' cross K/V of the same frames (None for gemma2)."""
    if not cfg.is_encoder_decoder:
        return None, None
    jenc = JMD._stacked_cross_kv(jparams, jcfg,
                                 JMD.encoder_forward(jparams, jcfg, jnp.asarray(frames)))
    enc = MD.encode(params, cfg, torch.from_numpy(frames))
    return jenc, enc


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hidden_forward_and_prefill_match(variant):
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg)
    toks, frames = _tokens(cfg, (B, T), 1), _frames(cfg, B, 11)
    jenc, enc = _enc_kv(jparams, jcfg, params, cfg, frames)
    if enc is not None:
        _assert_nested_close(enc, jenc, HIDDEN_TOL)
    jh, jcaches, _ = JMD.hidden_forward(
        jparams, jcfg, JMD.embed_tokens(jparams, jcfg, jnp.asarray(toks)),
        positions=jnp.arange(T), enc_kv=jenc, keep_cache=True)
    h, caches, _ = MD.hidden_forward(
        params, cfg, MD.embed_tokens(params, cfg, torch.from_numpy(toks)),
        positions=torch.arange(T, dtype=torch.int32), enc_kv=enc,
        keep_cache=True)
    np.testing.assert_allclose(_np(h), _np(jh), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    _assert_nested_close(caches, jcaches, HIDDEN_TOL)

    batch = {"tokens": toks, "frames": frames} if enc is not None else {"tokens": toks}
    jlogits, _, _ = JMD.prefill(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    logits, _ = TSV.make_prefill(cfg)(params, {k: torch.from_numpy(v)
                                               for k, v in batch.items()})
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    _assert_ulp(logits, jlogits)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match(variant):
    """12 decode steps with caches (gemma2's local ring of 8 slots evicts):
    per-step logits, then every cache."""
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg)
    toks = _tokens(cfg, (B, T), 2)
    jenc, enc = _enc_kv(jparams, jcfg, params, cfg, _frames(cfg, B, 12))
    jcaches = JMD.init_decode_caches(jcfg, B, T, dtype=jnp.float32)
    caches = MD.init_decode_caches(cfg, B, T, dtype=torch.float32, device="cpu")
    _assert_nested_close(caches, jcaches, 0)        # shapes, EMPTY_POS
    step = TSV.make_decode_step(cfg)
    for pos in range(T):
        jlogits, jcaches = JMD.decode_step(jparams, jcfg, jcaches,
                                           jnp.asarray(toks[:, pos:pos + 1]),
                                           pos, enc_kv=jenc)
        logits, caches = step(params, caches,
                              torch.from_numpy(toks[:, pos:pos + 1]), pos, enc_kv=enc)
        assert logits.dtype == torch.bfloat16
        _assert_ulp(logits, jlogits)
    _assert_nested_close(caches, jcaches, HIDDEN_TOL)


def test_ring_cache_eviction_matches_reference():
    """The reference's ring-eviction case (tests/test_serve.py): reduced
    gemma2 with a window of 8 decoded for 24 steps, so the local ring
    wraps twice; the port's decode against the reference's, and against
    its own full forward."""
    upd = dict(dtype="float32", param_dtype="float32", attn_window=8)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma2-2b")), **upd)
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), **upd)
    jparams, params = _params(jcfg, cfg, seed=1)
    toks = _tokens(cfg, (1, 24), 5)
    jcaches = JMD.init_decode_caches(jcfg, 1, 24, dtype=jnp.float32)
    caches = MD.init_decode_caches(cfg, 1, 24, dtype=torch.float32, device="cpu")
    assert caches[0][0][0].shape[2] == 8 and caches[0][1][0].shape[2] == 24
    for pos in range(24):
        jlogits, jcaches = JMD.decode_step(jparams, jcfg, jcaches,
                                           jnp.asarray(toks[:, pos:pos + 1]), pos)
        logits, caches = MD.decode_step(params, cfg, caches,
                                        torch.from_numpy(toks[:, pos:pos + 1]), pos)
        _assert_ulp(logits, jlogits)
    # slot i of the local ring holds position 16 + i after 24 steps
    np.testing.assert_array_equal(caches[0][0][2][0].numpy(), np.arange(16, 24))
    h, _, _ = MD.hidden_forward(params, cfg, MD.embed_tokens(params, cfg, torch.from_numpy(toks)),
                             positions=torch.arange(24, dtype=torch.int32))
    full = MD.logits_fn(params, cfg, h[:, -1:])[:, 0]
    np.testing.assert_allclose(_np(logits), _np(full), atol=5e-3, rtol=5e-3)


GREEDY_SEED = {"gemma2_h4kv2": 6, "whisper": 3}   # no top-2 ties


@pytest.mark.parametrize("variant", sorted(GREEDY_SEED))
def test_greedy_generate_tokens_identical(variant):
    """Greedy tokens identical, on a seed whose every step's top-2 bf16
    logits are more than one ulp apart (a tie would decide on rounding)."""
    seed = GREEDY_SEED[variant]
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg, seed=seed)
    prompt = _tokens(cfg, (B, 6), seed + 3)
    frames = _frames(cfg, B, seed + 4)
    n_steps = 8
    extras = {"frames": frames} if cfg.is_encoder_decoder else {}
    ref = np.asarray(jax_greedy_generate(
        jparams, jcfg, jnp.asarray(prompt), n_steps,
        batch_extras={k: jnp.asarray(v) for k, v in extras.items()}))
    out = TSV.greedy_generate(params, cfg, torch.from_numpy(prompt), n_steps,
                              batch_extras={k: torch.from_numpy(v)
                                            for k, v in extras.items()})
    assert tuple(out.shape) == (B, n_steps)
    np.testing.assert_array_equal(out.numpy(), ref)

    jenc = None
    if cfg.is_encoder_decoder:
        jenc = JMD._stacked_cross_kv(
            jparams, jcfg, JMD.encoder_forward(jparams, jcfg, jnp.asarray(frames)))
    S = prompt.shape[1]
    caches = JMD.init_decode_caches(jcfg, B, S + n_steps)
    tok = None
    for pos in range(S + n_steps - 1):
        cur = jnp.asarray(prompt[:, pos:pos + 1]) if pos < S else tok
        logits, caches = JMD.decode_step(jparams, jcfg, caches, cur, pos, enc_kv=jenc)
        if pos >= S - 1:
            top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
            gap = top2[:, 1] - top2[:, 0]
            assert (gap > BF16_ULP * np.abs(top2[:, 1])).all(), (pos, gap)
        tok = jnp.argmax(logits, axis=-1)[:, None]


def _batches(cfg, seed, b=B, s=16):
    toks = _tokens(cfg, (b, s), seed)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.is_encoder_decoder:
        frames = _frames(cfg, b, seed + 50)
        jb["frames"], tb["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    return jb, tb


def _jax_loss_and_grads(jparams, jcfg, jbatch, remat="none"):
    def loss_for(p):
        return JMD.loss_fn(p, jcfg, jbatch, remat=remat)
    (loss, _), grads = jax.value_and_grad(loss_for, has_aux=True)(jparams)
    return loss, pvalues(grads)


def _convert(ref_tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, ref_tree), cfg, device="cpu")


def _assert_trees_close(port, ref, cfg, atol, rtol):
    conv = _convert(ref, cfg)
    assert len(tree_leaves(port)) == len(tree_leaves(conv))
    tree_map(lambda a, b: np.testing.assert_allclose(_np(a), _np(b), atol=atol,
                                                     rtol=rtol), port, conv)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match(variant):
    """Loss and every grad against ``jax.grad``. whisper's reference loss
    never feeds the encoder to the decoder, so its encoder grads are zero
    in both packages."""
    jcfg, cfg = _cfgs(variant)
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batches(cfg, 1)
    jloss, jgrads = _jax_loss_and_grads(jparams, jcfg, jbatch)
    loss, metrics, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(metrics["tokens"]) == B * 15
    _assert_trees_close(grads, jgrads, cfg, atol=1e-5, rtol=1e-4)
    if cfg.is_encoder_decoder:
        assert all(not g.any() for g in tree_leaves(grads["encoder"]))


def _states(jcfg, cfg, jtcfg, tcfg, seed=0):
    jparams, params = _params(jcfg, cfg, seed)
    jstate = JTS.init_train_state(jax.random.PRNGKey(seed), jcfg, jtcfg)
    jstate = jstate._replace(params=jparams)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    ef = (init_error_feedback(params)
          if tcfg.grad_compression == "int8_ef" else None)
    return jstate, TS.TrainState(params, opt_init(params, tcfg), ef)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_steps_adamw(variant):
    """Two adamw steps (remat "dots", as chip_smoke trains) against the
    reference's un-jitted step, params at atol 1e-5."""
    jcfg, cfg = _cfgs(variant)
    kw = dict(optimizer="adamw", remat_policy="dots", warmup_steps=1, total_steps=4)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jstep, step = JTS.make_train_step(jcfg, jtcfg), TS.make_train_step(cfg, tcfg)
    for i in range(2):
        jbatch, tbatch = _batches(cfg, 10 + i)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert state.opt.step == 2
    _assert_trees_close(state.params, pvalues(jstate.params), cfg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["gemma2_h4kv2", "whisper"])
def test_bf16_loss_grads_and_decode_at_bf16_tolerance(variant):
    """bf16 weights and activations: the packages round bf16 at different
    places, so loss, grads and decode logits agree to 2e-2 (the reference
    kernel tests' bf16 tolerance); grads stay bf16."""
    jcfg, cfg = _cfgs(variant, fp32=False)
    jparams, params = _params(jcfg, cfg)
    jbatch, tbatch = _batches(cfg, 1)
    jloss, jgrads = _jax_loss_and_grads(jparams, jcfg, jbatch)
    loss, _, grads = TS._grad_fn(cfg, TrainConfig(remat_policy="none"))(params, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.dtype == p.dtype
    _assert_trees_close(grads, jgrads, cfg, atol=2e-2, rtol=2e-2)

    toks = _tokens(cfg, (B, 8), 4)
    jenc, enc = _enc_kv(jparams, jcfg, params, cfg, _frames(cfg, B, 14))
    jcaches = JMD.init_decode_caches(jcfg, B, 8)
    caches = MD.init_decode_caches(cfg, B, 8, device="cpu")
    for pos in range(8):
        jlogits, jcaches = JMD.decode_step(jparams, jcfg, jcaches,
                                           jnp.asarray(toks[:, pos:pos + 1]),
                                           pos, enc_kv=jenc)
        logits, caches = MD.decode_step(params, cfg, caches,
                                        torch.from_numpy(toks[:, pos:pos + 1]),
                                        pos, enc_kv=enc)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# whisper: the encoder, its frames and its leaves under the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,seed", [(0, 0), (3, 5)])
def test_make_batch_for_frames_bit_equal(step, seed):
    for cut in (False, True):
        jcfg, cfg = jax_get_config("whisper-tiny"), get_config("whisper-tiny")
        if cut:
            jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
        ref = jax_make_batch_for(jcfg, 2, 8, step=step, seed=seed)
        port = make_batch_for(cfg, 2, 8, step=step, seed=seed)
        assert sorted(port) == sorted(ref) == ["frames", "tokens"]
        assert port["frames"].dtype == torch.float32
        assert tuple(port["frames"].shape) == (2, cfg.encoder_seq_len, cfg.d_model)
        np.testing.assert_array_equal(port["frames"].numpy().view(np.int32),
                                      np.asarray(ref["frames"]).view(np.int32))
        np.testing.assert_array_equal(port["tokens"].numpy(), np.asarray(ref["tokens"]))


def test_encoder_forward_matches():
    """The non-causal encoder and its final norm, in fp32."""
    jcfg, cfg = _cfgs("whisper")
    jparams, params = _params(jcfg, cfg)
    frames = _frames(cfg, B, 21)
    ref = JMD.encoder_forward(jparams, jcfg, jnp.asarray(frames))
    out = MD.encoder_forward(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(out), _np(ref), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    # non-causal: the first position sees the last frame
    bumped = frames.copy()
    bumped[:, -1] += 1.0
    out2 = MD.encoder_forward(params, cfg, torch.from_numpy(bumped))
    assert not torch.equal(out[:, 0], out2[:, 0])


def test_whisper_reference_leaves_stack_the_encoder():
    """One reference leaf per stacked encoder leaf, as for the decoder."""
    _, cfg = _cfgs("whisper")
    params = MD.init_model(cfg, seed=0, device="cpu")
    groups = dict(reference_leaves(params))
    enc = {k: v for k, v in groups.items() if k[0] == "encoder"}
    assert ("encoder", "segments", 0, "attn", "wq", "weight") in enc
    assert ("encoder", "final_norm", "scale") in enc
    for k, idx in enc.items():
        assert len(idx) == (1 if k[1] == "final_norm" else cfg.n_encoder_layers), k


LAYER_MAGNITUDES = (0.05, 3.0)


@pytest.mark.parametrize("mode", ["int8", "int8_ef"])
def test_whisper_compress_tree_bit_equal(mode):
    """int8 and int8_ef over a reduced whisper grads tree in the
    reference's layout, each layer of a stacked leaf (decoder and encoder)
    at its own magnitude: compressed grads and residuals of three steps bit
    for bit against the reference's codec, one scale per reference leaf."""
    jcfg, cfg = _cfgs("whisper")
    skel = jax.tree.map(np.asarray, pvalues(JMD.init_model(jax.random.PRNGKey(0), jcfg)))
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), skel)
    mags = np.asarray(LAYER_MAGNITUDES, np.float32)

    def by_layer(g):
        return g * mags.reshape((-1,) + (1,) * (g.ndim - 1))

    tree["segments"][0] = jax.tree.map(by_layer, tree["segments"][0])
    tree["encoder"]["segments"][0] = jax.tree.map(by_layer, tree["encoder"]["segments"][0])
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


def test_whisper_train_step_int8_ef():
    """One sgd step through int8_ef on reduced whisper: params and
    residuals within one quantization step of the reference's (grads that
    differ in the last fp32 bits can round to either side of a half-ulp)."""
    jcfg, cfg = _cfgs("whisper")
    kw = dict(optimizer="sgd", grad_compression="int8_ef", remat_policy="none",
              warmup_steps=0, total_steps=4, learning_rate=1e-2)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jbatch, tbatch = _batches(cfg, 1)
    _, jgrads = _jax_loss_and_grads(jstate.params, jcfg, jbatch)
    jnew, jm = JTS.make_train_step(jcfg, jtcfg)(jstate, jbatch)
    new, m = TS.make_train_step(cfg, tcfg)(state, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    ref_ef = tree_leaves(_convert(pvalues(jnew.ef), cfg))
    ref_p = tree_leaves(_convert(pvalues(jnew.params), cfg))
    g = tree_leaves(_convert(jgrads, cfg))
    ef, p = tree_leaves(new.ef), tree_leaves(new.params)
    for _, idx in reference_leaves(new.params):
        scale = max(float(np.abs(_np(g[i])).max()) for i in idx) / 127.0
        for i in idx:
            np.testing.assert_allclose(_np(ef[i]), _np(ref_ef[i]), rtol=0,
                                       atol=scale * 1.001 + 1e-7)
            np.testing.assert_allclose(_np(p[i]), _np(ref_p[i]), rtol=0,
                                       atol=1e-2 * scale * 1.001 + 1e-6)


def test_whisper_adafactor_step_matches():
    """adafactor keeps its factored moments per reference leaf, the
    encoder's stacked as the decoder's: one step's params and moments
    against the reference's."""
    jcfg, cfg = _cfgs("whisper")
    kw = dict(optimizer="adafactor", remat_policy="none", warmup_steps=0,
              total_steps=4, learning_rate=1e-2)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = _states(jcfg, cfg, jtcfg, tcfg)
    jbatch, tbatch = _batches(cfg, 3)
    jnew, jm = JTS.make_train_step(jcfg, jtcfg)(jstate, jbatch)
    new, m = TS.make_train_step(cfg, tcfg)(state, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_trees_close(new.params, pvalues(jnew.params), cfg, atol=1e-5, rtol=1e-5)
    groups = reference_leaves(new.params)
    assert len(new.opt.nu) == len(groups)
    (enc_wq,) = [i for i, (k, _) in enumerate(groups)
                 if k == ("encoder", "segments", 0, "attn", "wq", "weight")]
    row, col = new.opt.nu[enc_wq]
    assert row.shape == (cfg.n_encoder_layers, cfg.d_model)
