"""The flash attention kernels' dispatch and the split-KV algorithm, on the CPU.

``FA.plan`` maps shapes and dtypes to one of the three kernel designs and
the split-KV decode kernel's split count; it is pure Python and runs the same
here as on the card. ``FA.attention_splitkv_plain`` is the split-KV kernel's
algorithm (per-split (acc, m, l) with its -inf / NEG_INF rules, then its
combine) in plain PyTorch: it is held to ``attention_plain``, the
reference's interpret-mode Pallas kernel and ``attend_naive`` within 1e-5 in
fp32 (summation order only: the splits regroup the same fp32 sums), at the
head dims of the reference's kernel tests and at gemma2-2b's 256 and MLA's
192 with gemma2's softcap and a window that bites.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as A

FLASH_CASES = [    # tests/test_kernels.py's: B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap
    (1, 128, 128, 2, 2, 16, True, 0, 0.0),
    (2, 64, 192, 4, 2, 32, True, 0, 0.0),
    (1, 128, 128, 4, 1, 16, True, 32, 0.0),
    (1, 96, 96, 2, 2, 16, True, 0, 20.0),
    (2, 1, 256, 4, 2, 16, True, 0, 0.0),
    (1, 64, 64, 3, 1, 8, False, 0, 0.0),
    (1, 80, 144, 6, 3, 24, True, 48, 30.0),
]
TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


def _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd), np.float32),
            rng.standard_normal((B, Skv, Hkv, hd), np.float32),
            rng.standard_normal((B, Skv, Hkv, hd), np.float32))


def _plan(B, Sq, Hq, Skv, Hkv, hd, dtype=BF16, kv_dtype=None, **kw):
    kv_dtype = kv_dtype or dtype
    return FA.plan((B, Sq, Hq, hd), (B, Skv, Hkv, hd), dtype, kv_dtype, kv_dtype, **kw)


@pytest.mark.parametrize("q_dtype,kv_dtype,hd", [
    (F32, F32, 128), (F32, F32, 64), (F32, BF16, 128), (BF16, F32, 64),
    (BF16, BF16, 8), (BF16, BF16, 16), (BF16, BF16, 24), (BF16, BF16, 32),
    (BF16, BF16, 96), (BF16, BF16, 160)])
def test_plan_fp32_and_other_head_dims_take_cuda_cores(q_dtype, kv_dtype, hd):
    for Sq in (1, 512):
        assert _plan(2, Sq, 4, 512, 2, hd, q_dtype, kv_dtype) == FA.Plan("cuda_core")


@pytest.mark.parametrize("shape", [
    (8, 512, 15, 512, 5, 64),      # smollm training
    (4, 32, 16, 32, 2, 128),       # qwen prefill
    (1, 3, 8, 64, 1, 64),          # 24 rows of one kv head
    (2, 17, 2, 40, 2, 128)])       # G = 1, 17 rows
def test_plan_bf16_many_rows_take_the_tile_kernel(shape):
    assert _plan(*shape) == FA.Plan("tile")


@pytest.mark.parametrize("shape", [
    (8, 512, 8, 512, 4, 256),      # gemma2-2b training (G 2)
    (4, 32, 8, 32, 4, 256),        # gemma2-2b prefill
    (1, 256, 8, 4352, 4, 256),     # gemma2-2b prefill where the window bites
    (4, 32, 128, 32, 128, 192),    # deepseek-v3's MLA prefill (Hkv = H)
    (8, 128, 16, 128, 16, 192),    # MLA training rows
    (1, 9, 2, 9, 1, 256)])         # 18 rows of one kv head: past one mma tile
def test_plan_bf16_head_dims_192_and_256_take_the_tile_kernel(shape):
    assert _plan(*shape) == FA.Plan("tile")
    assert _plan(*shape, dtype=F32) == FA.Plan("cuda_core")


@pytest.mark.parametrize("shape", [
    (4, 1, 16, 64, 2, 128),        # qwen decode, 64-slot cache
    (4, 1, 16, 4096, 2, 128),      # 4096-slot cache
    (2, 2, 8, 100, 1, 64),         # Sq * G = 16
    (1, 1, 1, 7, 1, 64),
    (4, 1, 8, 64, 4, 256),         # gemma2-2b decode, 64-slot ring
    (4, 1, 8, 4096, 4, 256),       # gemma2-2b decode, 4096-slot ring
    (4, 1, 16, 64, 16, 192),       # G = 1 at head_dim 192
    (2, 4, 8, 300, 2, 192)])       # Sq * G = 16 at 192
def test_plan_bf16_decode_takes_split_kv(shape):
    p = _plan(*shape)
    assert p.variant == "split_kv" and p.split_len % FA.KV_TILE == 0
    Skv = shape[3]
    assert (p.n_splits - 1) * p.split_len < Skv <= p.n_splits * p.split_len


def test_plan_split_counts():
    """A 64-slot cache runs one split (no combine launch, as many launches as
    calls); 4096 slots over B * Hkv = 8 get ~2 blocks an SM."""
    assert _plan(4, 1, 16, 64, 2, 128) == FA.Plan("split_kv", 1, FA.MIN_SPLIT)
    p = _plan(4, 1, 16, 4096, 2, 128)
    assert p == FA.Plan("split_kv", 32, 128)
    assert p.n_splits * 4 * 2 >= 2 * FA.NUM_SMS - 8
    assert _plan(32, 1, 16, 4096, 2, 128) == FA.Plan("split_kv", 5, 832)   # 64 kv heads
    assert _plan(4, 1, 16, 129, 2, 128) == FA.Plan("split_kv", 2, 128)     # last: 1 key
    # gemma2-2b decode (4 kv heads of 256, G 2): one split at 64 slots, and
    # 16 splits of 256 over B * Hkv = 16 blocks' worth of keys at 4096
    assert _plan(4, 1, 8, 64, 4, 256) == FA.Plan("split_kv", 1, FA.MIN_SPLIT)
    assert _plan(4, 1, 8, 4096, 4, 256) == FA.Plan("split_kv", 16, 256)


@pytest.mark.parametrize("q_shape,kv_shape,dtypes", [
    ((1, 4, 2, 12), (1, 8, 1, 12), (F32, F32, F32)),        # hd not a multiple of 8
    ((1, 4, 2, 264), (1, 8, 1, 264), (BF16, BF16, BF16)),   # hd above 256
    ((1, 4, 3, 64), (1, 8, 2, 64), (BF16, BF16, BF16)),     # 3 q heads over 2
    ((1, 4, 2, 64), (2, 8, 1, 64), (BF16, BF16, BF16)),     # batch differs
    ((1, 4, 2, 64), (1, 8, 1, 32), (BF16, BF16, BF16)),     # head dim differs
    ((1, 0, 2, 64), (1, 8, 1, 64), (BF16, BF16, BF16)),     # empty
    ((1, 4, 2, 64), (1, 8, 1, 64), (torch.float16,) * 3),   # fp16
    ((1, 4, 2, 64), (1, 8, 1, 64), (BF16, BF16, F32)),      # k and v differ
])
def test_plan_refuses_what_no_kernel_takes(q_shape, kv_shape, dtypes):
    with pytest.raises(ValueError, match="flash_attention"):
        FA.plan(q_shape, kv_shape, *dtypes)


@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 2), (3, 5), (32, 2), (64, 8)])
def test_plan_splits_cover_the_keys_and_none_is_empty(B, Hkv):
    """Whatever Skv, the splits are whole K/V tiles of at least MIN_SPLIT
    keys, cover every key, and the last holds at least one: the kernel never
    gets a split past Skv from the wrapper."""
    for Skv in (*range(1, 300), 1000, 4095, 4096, 4097, 32768, 131072):
        p = _plan(B, 1, 2 * Hkv, Skv, Hkv, 64)
        assert p.split_len % FA.KV_TILE == 0 and p.split_len >= FA.MIN_SPLIT
        assert (p.n_splits - 1) * p.split_len < Skv <= p.n_splits * p.split_len


@pytest.mark.parametrize("hd", [192, 256])
@pytest.mark.parametrize("B,Hkv,G", [(4, 4, 2), (1, 1, 16), (3, 5, 1), (32, 4, 2)])
def test_plan_splits_at_head_dims_192_and_256_cover_the_keys(B, Hkv, G, hd):
    """As above at the head dims of gemma2-2b (4 kv heads, G 2: (4, 4, 2)
    is its served decode) and of MLA: split_kv, with splits of whole K/V
    tiles of at least MIN_SPLIT keys that cover every key, none empty, and
    the same splits as at head_dim 64 (the K/V tile does not depend on it)."""
    for Skv in (*range(1, 300, 7), 1000, 4095, 4096, 4097, 32768):
        p = _plan(B, 1, G * Hkv, Skv, Hkv, hd)
        assert p.variant == "split_kv"
        assert p.split_len % FA.KV_TILE == 0 and p.split_len >= FA.MIN_SPLIT
        assert (p.n_splits - 1) * p.split_len < Skv <= p.n_splits * p.split_len
        assert p == _plan(B, 1, G * Hkv, Skv, Hkv, 64)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_splitkv_plain_matches_reference(case, n_splits):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = case
    arrays = _qkv(B, Sq, Skv, Hq, Hkv, hd)
    q, k, v = _torch(arrays)
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    spec = A.AttnSpec(causal=causal, window=window, logit_softcap=cap)
    jspec = JA.AttnSpec(causal=causal, window=window, logit_softcap=cap)
    tq, tkv = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    out = FA.attention_splitkv_plain(q, k, v, tq, tkv, spec, n_splits)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, Sq, Hq, hd)
    jx = [jnp.asarray(a) for a in arrays]
    kern = jax_flash(*jx, jnp.asarray(q_pos), jnp.asarray(kv_pos), jspec,
                     block_q=64, block_kv=64, interpret=True)
    naive = JA.attend_naive(*jx, jnp.asarray(q_pos), jnp.asarray(kv_pos), jspec)
    plain = FA.attention_plain(q, k, v, tq, tkv, spec)
    for ref in (plain, kern, naive):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_splitkv_plain_ring_cache_with_empty_slots(n_splits):
    """A wrapped ring of 192 slots, a third of them empty (PAD_POS), one
    decode row per q head over 8 q heads of each kv head."""
    arrays = _qkv(2, 1, 192, 16, 2, 64, seed=3)
    q, k, v = _torch(arrays)
    kv_pos = np.concatenate([np.arange(200, 264), np.arange(136, 200),
                             np.full(64, FA.PAD_POS)]).astype(np.int32)
    q_pos = np.array([263], np.int32)
    spec = A.AttnSpec(causal=True, window=100)
    jspec = JA.AttnSpec(causal=True, window=100)
    tq, tkv = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    out = FA.attention_splitkv_plain(q, k, v, tq, tkv, spec, n_splits)
    kern = jax_flash(*[jnp.asarray(a) for a in arrays], jnp.asarray(q_pos),
                     jnp.asarray(kv_pos), jspec, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(kern), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_f32(out), _f32(FA.attention_plain(q, k, v, tq, tkv, spec)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("hd,Sq,Hq,Hkv", [
    (256, 1, 8, 4),      # gemma2-2b decode: G 2
    (256, 8, 8, 4),      # 8 queries x G 2: the 16 rows of one split-KV block
    (192, 1, 4, 4),      # MLA's qk dim, G 1 (Hkv = H)
    (192, 4, 8, 2)])     # 4 queries x G 4
def test_splitkv_plain_at_head_dims_192_and_256_matches_attend_naive(hd, Sq, Hq, Hkv,
                                                                     n_splits):
    """gemma2-2b's softcap 50 over scores scaled up so that it bites, and a
    window of 48 over 200 keys, so the first split of 128 keys is wholly
    masked (m = NEG_INF, weight 0 beside the live split) and at n_splits 3
    the last holds no key (m = -inf). fp32, within 1e-5 of attend_naive
    and attention_plain: the splits regroup the same fp32 sums."""
    Skv = 200
    q, k, v = _qkv(1, Sq, Skv, Hq, Hkv, hd, seed=hd + Sq)
    q = q * np.float32(16.0)          # |scale·q·k| ~ 16: tanh(s / 50) bends
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    spec = A.AttnSpec(causal=True, window=48, logit_softcap=50.0)
    jspec = JA.AttnSpec(causal=True, window=48, logit_softcap=50.0)
    tq, tkv = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    tqkv = _torch((q, k, v))
    out = FA.attention_splitkv_plain(*tqkv, tq, tkv, spec, n_splits)
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, Sq, Hq, hd)
    naive = JA.attend_naive(*[jnp.asarray(a) for a in (q, k, v)], jnp.asarray(q_pos),
                            jnp.asarray(kv_pos), jspec)
    np.testing.assert_allclose(_f32(out), _f32(naive), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_f32(out), _f32(FA.attention_plain(*tqkv, tq, tkv, spec)),
                               atol=TOL, rtol=TOL)
    capped = FA.attention_splitkv_plain(*tqkv, tq, tkv, spec._replace(logit_softcap=0.0),
                                        n_splits)
    assert (capped - out).abs().max() > 1e-2    # the softcap changes the answer


@pytest.mark.parametrize("n_splits", [1, 3, 4])
def test_splitkv_plain_wholly_masked_row_is_mean_of_v(n_splits):
    """No attendable key in any split: every split's m is NEG_INF and counts,
    so the row is mean(v) over all Skv, as attend_naive gives."""
    arrays = _qkv(2, 1, 130, 8, 2, 64, seed=4)
    q, k, v = _torch(arrays)
    q_pos, kv_pos = np.array([0], np.int32), np.arange(1, 131, dtype=np.int32)
    out = FA.attention_splitkv_plain(q, k, v, torch.from_numpy(q_pos),
                                     torch.from_numpy(kv_pos), A.AttnSpec(), n_splits)
    naive = JA.attend_naive(*[jnp.asarray(a) for a in arrays], jnp.asarray(q_pos),
                            jnp.asarray(kv_pos), JA.AttnSpec())
    np.testing.assert_allclose(_f32(out), _f32(naive), atol=TOL, rtol=TOL)
    mean_v = v.mean(dim=1, keepdim=True).repeat_interleave(4, dim=2)
    np.testing.assert_allclose(_f32(out), _f32(mean_v), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_splitkv_plain_last_split_past_the_keys(masked):
    """129 keys in 4 splits of 64: the last split holds no key (m = -inf,
    weight 0), the third holds one. Also with every key masked, where the
    empty split must still not count."""
    assert FA.split_len_for(129, 4) == 64 and 3 * 64 >= 129
    arrays = _qkv(1, 1, 129, 4, 1, 64, seed=5)
    q, k, v = _torch(arrays)
    q_pos = np.array([0 if masked else 128], np.int32)
    kv_pos = np.arange(1, 130, dtype=np.int32) if masked else np.arange(129, dtype=np.int32)
    spec = A.AttnSpec(causal=True)
    tq, tkv = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    out = FA.attention_splitkv_plain(q, k, v, tq, tkv, spec, 4)
    assert torch.isfinite(out).all()
    naive = JA.attend_naive(*[jnp.asarray(a) for a in arrays], jnp.asarray(q_pos),
                            jnp.asarray(kv_pos), JA.AttnSpec(causal=True))
    np.testing.assert_allclose(_f32(out), _f32(naive), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_f32(out), _f32(FA.attention_plain(q, k, v, tq, tkv, spec)),
                               atol=TOL, rtol=TOL)


def test_variant_counters_name_every_design():
    assert set(FA.LAUNCHES_BY_VARIANT) == set(FA.VARIANTS) == {
        "cuda_core", "tile", "split_kv", "split_kv_combine"}
    assert {FA.plan((1, s, 2, hd), (1, 64, 1, hd), dt, dt, dt).variant
            for s, hd, dt in ((1, 64, BF16), (64, 64, BF16), (1, 64, F32))
            } == set(FA.VARIANTS) - {"split_kv_combine"}


def test_copy_ab_tool_switches_off_only_the_strided_copy(tmp_path, monkeypatch):
    """``repro_torch.tools.flash_copy_ab`` builds the source beside a copy
    that differs only in ``load_kv``'s strided loop being switched off, and
    reads each tile and split-KV instantiation's registers and spill stores
    from an nvcc log (the combine kernel is not one of them)."""
    from repro_torch.kernels import nvcc
    from repro_torch.tools import flash_copy_ab as AB

    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path))
    src = open(FA.SOURCE).read()
    walk = open(AB.walk_source(FA, nvcc)).read()
    assert src.count(AB.STRIDED) == 1 and AB.STRIDED not in walk
    assert walk == src.replace(AB.STRIDED, "if constexpr (false) {")
    assert (tmp_path / "flash_copy_ab" / "mma_sm90.cuh").exists()
    log = tmp_path / "build.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN3_GN21flash_fwd_tile_kernelILi64EEEvNS_4ArgsE'"
        " for 'sm_90a'\n    40 bytes stack frame, 36 bytes spill stores, 44 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 40 bytes cumulative stack size\n"
        "ptxas info    : Compiling entry function '_ZN3_GN24flash_fwd_splitkv_kernelILi256EEEvNS_4"
        "ArgsE' for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 240 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN3_GN24flash_fwd_combine_kernelENS_4ArgsE'"
        " for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers\n")
    assert AB.registers(str(log)) == {"tile<64>": (128, 36), "splitkv<256>": (240, 0)}
