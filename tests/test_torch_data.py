"""Port parity: synthetic tokens, the vision stub's patches, the registry
and the configs equal the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import TokenStream as JaxTokenStream
from repro.data import make_batch_for as jax_make_batch_for
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data import TokenStream, make_batch_for

STREAMS = [  # vocab, batch, seq, seed, step
    (512, 2, 8, 0, 0),
    (512, 4, 32, 0, 3),
    (151936, 4, 32, 0, 0),
    (49152, 3, 17, 7, 11),
    (1000, 1, 1, 123, 2 ** 20),
]


@pytest.mark.parametrize("vocab,batch,seq,seed,step", STREAMS)
def test_token_stream_bit_equal(vocab, batch, seq, seed, step):
    ref = JaxTokenStream(vocab, batch, seq, seed)
    port = TokenStream(vocab, batch, seq, seed)
    np.testing.assert_array_equal(port.batch_np(step), ref.batch_np(step))
    t = port.batch(step)
    assert t.dtype == torch.int32 and tuple(t.shape) == (batch, seq)
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref.batch(step)))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "smollm-360m", "mamba2-370m"])
@pytest.mark.parametrize("step,seed", [(0, 0), (5, 3)])
def test_make_batch_for_tokens_bit_equal(arch, step, seed):
    for cut in (False, True):
        jcfg, pcfg = jax_get_config(arch), get_config(arch)
        if cut:
            jcfg, pcfg = jax_reduced(jcfg), reduced(pcfg)
        ref = jax_make_batch_for(jcfg, 4, 16, step=step, seed=seed)["tokens"]
        port = make_batch_for(pcfg, 4, 16, step=step, seed=seed)["tokens"]
        assert port.dtype == torch.int32
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "smollm-360m", "mamba2-370m",
                                  "gemma2-2b", "whisper-tiny", "nemotron-4-15b",
                                  "zamba2-1.2b", "llama4-scout-17b-a16e",
                                  "deepseek-v3-671b", "internvl2-76b"])
def test_configs_equal_reference(arch):
    """Field for field, full and reduced, and ``param_count``, which for a
    hybrid (zamba2) is the reference's number: it adds a dense MLP to every
    SSM layer that the model's tree does not hold."""
    full_ref, full = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_ref)
    assert dataclasses.asdict(reduced(full)) == dataclasses.asdict(jax_reduced(full_ref))
    assert full.param_count() == full_ref.param_count()
    assert full.get_head_dim() == full_ref.get_head_dim()


def test_qwen_full_width_size():
    cfg = get_config("qwen2.5-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.get_head_dim(), cfg.d_ff, cfg.vocab_size) == \
        (36, 2048, 16, 2, 128, 11008, 151936)
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert 3.0e9 < cfg.param_count() < 3.2e9


def test_registry_equals_reference():
    """Every arch of the reference's registry, in its order; an unknown one
    raises as the reference's does."""
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("step,seed", [(0, 0), (4, 9)])
def test_make_batch_for_patches_bit_equal(cut, step, seed):
    """internvl2's patch embeddings [B, n_frontend_tokens, d_model] fp32 and
    its tokens cut to max(seq - n, 1), bit for bit, full and reduced."""
    jcfg, cfg = jax_get_config("internvl2-76b"), get_config("internvl2-76b")
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    for seq in (cfg.n_frontend_tokens + 8, 4):
        ref = jax_make_batch_for(jcfg, 2, seq, step=step, seed=seed)
        port = make_batch_for(cfg, 2, seq, step=step, seed=seed)
        assert sorted(port) == sorted(ref) == ["patches", "tokens"]
        assert port["patches"].dtype == torch.float32
        assert tuple(port["patches"].shape) == (2, cfg.n_frontend_tokens, cfg.d_model)
        assert tuple(port["tokens"].shape) == (2, max(seq - cfg.n_frontend_tokens, 1))
        np.testing.assert_array_equal(port["patches"].numpy().view(np.int32),
                                      np.asarray(ref["patches"]).view(np.int32))
        np.testing.assert_array_equal(port["tokens"].numpy(), np.asarray(ref["tokens"]))
