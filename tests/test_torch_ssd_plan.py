"""The SSD scan kernels' dispatch and the tensor-core design's arithmetic, on
the CPU.

``SSD.plan`` maps shapes, dtype, strides and base pointers to one of the two
kernel designs (``mma``, ``cuda_core``) or raises; it is pure Python and runs
the same here as on the card. ``SSD.ssd_mma_plain`` is the ``mma`` kernel's
passes and rounding points (S̃ = C·Bᵀ ⊙ L ⊙ dt and x̃ = x ⊙ dt ⊙ decay
rounded to bf16, the carried state rounded to bf16 for C·stateᵀ) in plain
PyTorch. It is held to the reference's interpret-mode Pallas kernel and to
``ssd_reference`` in fp32 at the reference's own bf16 kernel tolerance, atol
5e-2 (``tests/test_kernels.py``): the bf16 roundings move y by about one bf16
ulp of |y| ≤ 4 (1.6e-2), well inside it.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssm as JS
from repro_torch.kernels import nvcc
from repro_torch.kernels import ssd_scan as SSD

SSD_CASES = [  # tests/test_kernels.py: b, l, h, p, g, n, chunk
    (1, 128, 2, 16, 1, 8, 32),
    (2, 64, 4, 8, 2, 16, 16),
    (1, 256, 8, 16, 1, 32, 64),
    (1, 32, 2, 8, 1, 8, 32),         # single chunk
]
TRAIN = (8, 512, 32, 64, 1, 128, 256)     # mamba2-370m, batch 8 x seq 512
MAMBA2_HEADS = (1, 512, 2, 64, 1, 128, 256)   # its head shape, two heads
ATOL = 5e-2
BF16, F32 = torch.bfloat16, torch.float32


def _plan(case, dtype, **kw):
    b, l, h, p, g, n, chunk = case
    return SSD.plan((b, l, h, p), (b, l, g, n), dtype, chunk, **kw)


def _mma_case(case):
    return case[3] % 16 == 0 and case[5] % 16 == 0


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,dtype,want", [
    (TRAIN, BF16, "mma"), (TRAIN, F32, "cuda_core"),
    *[(c, BF16, "mma" if _mma_case(c) else "cuda_core") for c in SSD_CASES],
    *[(c, F32, "cuda_core") for c in SSD_CASES],
])
def test_plan_routes_by_dtype_and_dims(case, dtype, want):
    chosen = _plan(case, dtype)
    assert chosen.variant == want
    p, n, chunk = case[3], case[5], case[6]
    smem = SSD.mma_smem_bytes(p, n, chunk) if want == "mma" else SSD.smem_bytes(p, n, chunk)
    assert chosen.smem == smem <= SSD.MAX_SMEM


def _conv_slices(b, l, h, p, g, n, pad=0, offset=0):
    """x, B, C as views of one bf16 [b, l, h*p + 2*g*n + pad] tensor, as the
    model slices its conv output, starting ``offset`` elements into it."""
    width = h * p + 2 * g * n + pad
    flat = torch.zeros(offset + b * l * width, dtype=BF16)
    xbc = flat[offset:].view(b, l, width)
    return (xbc[..., :h * p].unflatten(-1, (h, p)),
            xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n)),
            xbc[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n)))


def _plan_of(x, B, C, chunk):
    return SSD.plan(x.shape, B.shape, x.dtype, chunk,
                    (x.stride(), B.stride(), C.stride()),
                    (x.data_ptr(), B.data_ptr(), C.data_ptr()))


@pytest.mark.parametrize("pad,offset,want", [
    (0, 0, "mma"),            # the model's slices: rows of 2304 bf16
    (4, 0, "cuda_core"),      # rows of 4616 B: not a multiple of 16
    (0, 4, "cuda_core"),      # every base 8 B past a 16-byte boundary
])
def test_plan_checks_alignment_of_the_model_slices(pad, offset, want):
    b, l, h, p, g, n, chunk = TRAIN
    x, B, C = _conv_slices(2, l, h, p, g, n, pad=pad, offset=offset)
    assert x.data_ptr() % 16 == 2 * offset % 16
    assert _plan_of(x, B, C, chunk).variant == want
    if pad == offset == 0:   # the byte offsets of B and C in the conv row
        assert [t.data_ptr() - x.data_ptr() for t in (B, C)] == [4096, 4352]


@pytest.mark.parametrize("strides,ptrs", [
    (None, (16, 32, 0)),
    (None, (0, 8, 0)),                                   # B's base
    (((512 * 2048, 2048, 64, 1), (512 * 136, 136, 128, 1), (512 * 128, 128, 128, 1)),
     (0, 0, 0)),                                         # B rows of 136: aligned
    (((512 * 2052, 2052, 64, 1), (512 * 128, 128, 128, 1), (512 * 128, 128, 128, 1)),
     (0, 0, 0)),                                         # x rows of 4104 B
    (((512 * 2048, 2048, 64, 1), (512 * 128, 128, 128, 1), (512 * 128, 128, 128, 2)),
     (0, 0, 0)),                                         # C not unit stride
])
def test_plan_takes_mma_only_for_aligned_rows(strides, ptrs):
    b, l = 1, 512
    x_shape, B_shape = (b, l, 32, 64), (b, l, 1, 128)
    aligned = all(ptr % 16 == 0 for ptr in ptrs) and (strides is None or all(
        st[3] == 1 and all(s * 2 % 16 == 0 for s in st[:3]) for st in strides))
    chosen = SSD.plan(x_shape, B_shape, BF16, 256, strides, ptrs)
    assert chosen.variant == ("mma" if aligned else "cuda_core")


@pytest.mark.parametrize("case,dtype", [
    ((1, 64, 1, 256, 1, 16, 64), F32),           # p > 128: no design
    ((1, 64, 1, 256, 1, 16, 64), BF16),
    ((1, 2048, 1, 128, 1, 256, 2048), F32),      # shared memory of either
    ((1, 64, 1, 16, 1, 16, 64), torch.float16),  # neither dtype
])
def test_plan_refuses_what_no_design_takes(case, dtype):
    with pytest.raises(ValueError, match="head_dim|shared memory|fp32 or bf16"):
        _plan(case, dtype)


@pytest.mark.parametrize("case,why", [
    ((1, 64, 2, 48, 1, 128, 64), "p not a power of two"),
    ((1, 64, 2, 64, 1, 96, 64), "n not a power of two"),
    ((1, 96, 2, 64, 1, 128, 24), "chunk not a multiple of 16"),
    ((1, 512, 2, 64, 1, 128, 512), "chunk over 256"),
    ((1, 256, 2, 128, 1, 256, 128), "p * n over 16384"),
    ((1, 256, 2, 64, 1, 256, 256), "tiles over the shared memory"),
])
def test_plan_sends_what_mma_does_not_take_to_cuda_cores(case, why):
    assert _plan(case, BF16).variant == "cuda_core", why


def test_variant_counters_name_every_design():
    assert set(SSD.LAUNCHES_BY_VARIANT) == set(SSD.VARIANTS) == {"cuda_core", "mma"}
    assert {_plan(TRAIN, dt).variant for dt in (BF16, F32)} == set(SSD.VARIANTS)


def test_library_name_hashes_the_included_header(tmp_path, monkeypatch):
    """An edited header rebuilds every source that includes it."""
    src, hdr = tmp_path / "k.cu", tmp_path / "blocks.cuh"
    src.write_text('#include "blocks.cuh"\n__global__ void k() {}\n')
    hdr.write_text("// v1\n")
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path))
    first = nvcc.library_path(str(src))
    hdr.write_text("// v2\n")
    assert nvcc.library_path(str(src)) != first
    assert nvcc.library_path(SSD.MMA_SOURCE) != nvcc.library_path(SSD.SOURCE)


# ---------------------------------------------------------------------------
# ssd_mma_plain: the mma kernel's arithmetic against the reference
# ---------------------------------------------------------------------------

def _inputs(case, seed, real=None):
    """x, dt, A, B, C, D as numpy, scaled as the reference's tests; x, B, C
    rounded to bf16 values. Rows from ``real`` on are zero, dt too, as
    ``mamba2_forward`` pads a prompt up to a chunk multiple."""
    b, l, h, p, g, n, _ = case
    r = np.random.default_rng(seed)
    arrays = [(r.standard_normal((b, l, h, p)) * 0.5).astype(np.float32),
              (np.log1p(np.exp(r.standard_normal((b, l, h)))) * 0.2).astype(np.float32),
              (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32),
              (r.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
              (r.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
              (1.0 + 0.5 * r.standard_normal(h)).astype(np.float32)]
    if real is not None:
        for i in (0, 1, 3, 4):
            arrays[i][:, real:] = 0
    for i in (0, 3, 4):
        arrays[i] = arrays[i].astype(ml_dtypes.bfloat16)
    return arrays


MMA_PLAIN_CASES = ([(f"ref{c}", c, None) for c in SSD_CASES if _mma_case(c)]
                   + [("mamba2_heads", MAMBA2_HEADS, None),
                      ("mamba2_heads_padded", (1, 256, 2, 64, 1, 128, 256), 32)])


def _mma_plain(arrays, chunk):
    t = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    for i in (0, 3, 4):
        t[i] = t[i].to(BF16)
    y, st = SSD.ssd_mma_plain(*t, chunk=chunk)
    assert y.dtype == st.dtype == BF16
    return y.float().numpy(), st.float().numpy()


def _report(label, what, y, st, yr, sr):
    errs = (np.abs(y - yr).max(), np.abs(st - sr).max())
    print(f"ssd_mma_plain vs {what} {label}: y max_abs_err={errs[0]:.3e} "
          f"state max_abs_err={errs[1]:.3e} atol={ATOL}")
    np.testing.assert_allclose(y, yr, atol=ATOL)
    np.testing.assert_allclose(st, sr, atol=ATOL)


@pytest.mark.parametrize("label,case,real", MMA_PLAIN_CASES)
def test_mma_plain_matches_pallas_interpret(label, case, real):
    assert _plan(case, BF16).variant == "mma"
    arrays = _inputs(case, seed=7, real=real)
    y, st = _mma_plain(arrays, case[-1])
    yk, sk = pallas_ssd_scan(*map(jnp.asarray, arrays), chunk=case[-1], interpret=True)
    _report(label, "Pallas (interpret)", y, st, np.asarray(yk, np.float32),
            np.asarray(sk, np.float32))


@pytest.mark.parametrize("label,case,real", MMA_PLAIN_CASES)
def test_mma_plain_matches_reference_fp32(label, case, real):
    arrays = _inputs(case, seed=8, real=real)
    y, st = _mma_plain(arrays, case[-1])
    yr, sr = JS.ssd_reference(*(jnp.asarray(a.astype(np.float32)) for a in arrays),
                              chunk=case[-1], return_state=True)
    _report(label, "ssd_reference fp32", y, st, np.asarray(yr, np.float32),
            np.asarray(sr, np.float32))


def test_mma_plain_padded_rows_leave_the_state():
    """Zero rows with dt = 0 past the prompt add nothing: the state after the
    padded chunk is the state after the prompt's rows alone."""
    case = (1, 256, 2, 64, 1, 128, 256)
    arrays = _inputs(case, seed=9, real=32)
    _, st = _mma_plain(arrays, 256)
    short = [a[:, :32] if a.ndim > 1 else a for a in arrays]
    _, st32 = _mma_plain(short, 32)
    np.testing.assert_allclose(st, st32, atol=ATOL)
