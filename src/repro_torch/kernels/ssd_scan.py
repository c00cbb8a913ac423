"""Mamba2 SSD chunked scan: hand-written CUDA kernels for Hopper, their
ctypes wrappers, launch counters, autograd Function and plain PyTorch
versions.

The kernels replace the Pallas TPU kernel of ``repro.kernels.ssd_scan``; the
note at the top of each source says how. They are compiled with ``nvcc`` for
``sm_90a`` at first use, from the repo's sources only, into ``kernels/build/``,
and loaded with ``ctypes``. Two designs; ``plan`` picks one per call from
shapes, dtype, strides and base pointers alone (so it runs the same on the
CPU):
- ``mma`` (``csrc/ssd_scan_mma.cu``): bf16 x, B, C with p in MMA_HEAD_DIMS,
  n in MMA_STATE_DIMS (p·n at most MMA_MAX_STATE), a chunk that is a
  multiple of MMA_ROWS up to MMA_MAX_CHUNK whose tiles fit in shared memory,
  and 16-byte-aligned rows and base pointers (mamba2 training and prefill):
  all four products on the tensor cores;
- ``cuda_core`` (``csrc/ssd_scan.cu``): everything else the kernels take
  (fp32, other head or state dims, misaligned slices): fp32 products on CUDA
  cores.

``ssd_scan`` launches on CUDA tensors and raises on any other;
``ssd_plain`` is the PyTorch counterpart of the reference's
``repro.models.ssm.ssd_reference``, with its dtype flow: in bf16 the C·Bᵀ
product and the carried state are rounded to bf16 where the reference rounds
them, while the CUDA-core kernel keeps both in fp32 as the Pallas kernel
does, so the two differ by more than the rounding of y in bf16.
``ssd_mma_plain`` mirrors the ``mma`` kernel's passes and rounding points
(tests and chip_smoke only). ``kernels.ops.ssd_chunked`` picks between kernel
and plain version by the tensors' device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from repro_torch.kernels import nvcc

SOURCE = os.path.join(nvcc.CSRC, "ssd_scan.cu")          # cuda_core
MMA_SOURCE = os.path.join(nvcc.CSRC, "ssd_scan_mma.cu")  # mma
SOURCES = (SOURCE, MMA_SOURCE)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                 # q / k rows per tile (csrc/ssd_scan.cu kTile)
MAX_HEAD_DIM = 128        # P (kMaxP): the y tile a block's threads hold
MAX_SMEM = 232448         # bytes of shared memory a block may use on an H100

VARIANTS = ("cuda_core", "mma")
MMA_HEAD_DIMS = (16, 32, 64, 128)          # P of the mma kernel's instances
MMA_STATE_DIMS = (16, 32, 64, 128, 256)    # N
MMA_MAX_STATE = 16384     # P·N: the fp32 state a block's registers hold
MMA_ROWS = 16             # q rows of an mma tile; the chunk is a multiple
MMA_MAX_CHUNK = 256       # one cumsum element per thread
MMA_ALIGN = 16            # bytes: x, B, C are copied 16 bytes at a time

LAUNCHES = 0              # ssd_scan calls since the last reset (plain int)
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)   # kernel launches by design
_LIB = None
_MMA_LIB = None


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k in (j, i]} x[..., k]; -inf above the diagonal.
    x: [..., T] -> [..., T, T]."""
    T = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_plain(x, dt, A, B, C, D, chunk: int = 64, h0=None,
              return_state: bool = False):
    """Chunked SSD scan (``repro.models.ssm.ssd_reference``).

    x [b,l,h,p]; dt [b,l,h] (softplus'd); A, D [h]; B, C [b,l,g,n] (g groups
    broadcast over h); h0 [b,h,p,n] an optional initial state. Returns y
    [b,l,h,p] (and the final state [b,h,p,n]), both in x's dtype. C·Bᵀ is a
    product in the inputs' dtype; the decays, dt and the scan are fp32; the
    carried state is cast to x's dtype before the inter-chunk product."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd: sequence {l} is not a multiple of chunk {chunk}")
    nch, rep = l // chunk, h // g
    f32 = torch.float32
    dtA = dt * A[None, None, :]                                  # fp32
    xc = x.reshape(b, nch, chunk, h, p)
    dtc = dt.reshape(b, nch, chunk, h).to(f32)
    dtAc = dtA.reshape(b, nch, chunk, h)
    Bh = B.reshape(b, nch, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nch, chunk, g, n).repeat_interleave(rep, dim=3)

    # intra-chunk
    Ls = torch.exp(segsum(dtAc.permute(0, 1, 3, 2)))             # [b,c,h,q,k]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh).to(f32) * torch.where(
        torch.isfinite(Ls), Ls, torch.zeros((), device=Ls.device))
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores, dtc, xc.to(f32))

    # chunk states
    decay_out = torch.exp(torch.flip(torch.cumsum(torch.flip(dtAc, [2]), 2), [2]))
    decay_states = decay_out / torch.exp(dtAc)                   # exp(sum_{k>q})
    states = torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchpn", Bh.to(f32), dtc,
                          decay_states, xc.to(f32))

    # inter-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(dtAc.sum(dim=2))                     # [b,c,h]
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if h0 is None else h0).to(f32)
    prev = []
    for c in range(nch):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # [b,c,h,p,n]

    decay_in = torch.exp(torch.cumsum(dtAc, dim=2))              # [b,c,q,h]
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Ch.to(f32), decay_in,
                           prev_states.to(x.dtype).to(f32))
    y = ((y_intra + y_inter).reshape(b, l, h, p)
         + x.to(f32) * D[None, None, :, None]).to(x.dtype)
    if return_state:
        return y, carry.to(x.dtype)
    return y


def ssd_mma_plain(x, dt, A, B, C, D, chunk: int):
    """The ``mma`` kernel's arithmetic in plain PyTorch (tests and chip_smoke
    only): (y [b,l,h,p], final state [b,h,p,n]) in x's dtype.

    Its passes and rounding points: cs = cumsum(dt·A) per chunk; S = C·Bᵀ
    with fp32 sums; S̃ = S·exp(cs_q − cs_k)·dt_k for k ≤ q (0 above), rounded
    to bf16; y = exp(cs_q)·C·bf16(state)ᵀ + S̃·x, then + D·x; the state
    update takes x̃ = bf16(x·dt·exp(cs_last − cs)), state = state·exp(cs_last)
    + x̃ᵀ·B in fp32. x, B, C enter as their values (bf16 in the kernel)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd: sequence {l} is not a multiple of chunk {chunk}")
    nch, rep = l // chunk, h // g
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(t):
        return t.to(bf16).to(f32)

    xc = x.reshape(b, nch, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nch, chunk, h).to(f32)
    Bc = B.reshape(b, nch, chunk, g, n).to(f32).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, nch, chunk, g, n).to(f32).repeat_interleave(rep, dim=3)
    cs = torch.cumsum(dtc * A.to(f32), dim=2)                      # [b,c,q,h]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    diff = (cs[:, :, :, None, :] - cs[:, :, None, :, :]).masked_fill(
        ~causal, float("-inf"))                                    # [b,c,q,k,h]
    S = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    St = rnd(S * torch.exp(diff) * dtc[:, :, None, :, :])
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", St, xc)
    xw = rnd(xc * (dtc * torch.exp(cs[:, :, -1:, :] - cs))[..., None])
    upd = torch.einsum("bcqhp,bcqhn->bchpn", xw, Bc)
    decay = torch.exp(cs[:, :, -1, :])                             # [b,c,h]
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for c in range(nch):
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Cc[:, c], rnd(state)
                               ) * torch.exp(cs[:, c])[..., None]
        ys.append(y_inter + y_intra[:, c])
        state = state * decay[:, c, :, None, None] + upd[:, c]
    y = (torch.stack(ys, dim=1).reshape(b, l, h, p)
         + x.to(f32) * D.to(f32)[None, None, :, None])
    return y.to(x.dtype), state.to(x.dtype)


# ---------------------------------------------------------------------------
# Plan: which kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    variant: str            # "cuda_core" or "mma"
    smem: int               # dynamic shared memory of one block, bytes


def mma_smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one ``mma`` block (csrc/ssd_scan_mma.cu):
    C and B [chunk][n+8], x [chunk][p+8] and the bf16 state [p][n+8]; cs, dt
    and the state weights [chunk] and 8 warp sums in fp32."""
    return (2 * (2 * chunk * (n + 8) + chunk * (p + 8) + p * (n + 8))
            + 4 * (3 * chunk + 8))


def _contiguous_strides(shape):
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def plan(x_shape, B_shape, dtype, chunk: int, strides=None,
         ptrs=(0, 0, 0)) -> Plan:
    """The kernel design for x [b,l,h,p] and B, C [b,l,g,n] of ``dtype``.
    ``strides`` holds x's, B's and C's strides in elements (contiguous when
    None), ``ptrs`` their base addresses. Raises ValueError for what neither
    design takes."""
    p, n = x_shape[3], B_shape[3]
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan: x {dtype}; fp32 or bf16")
    if strides is None:
        strides = (_contiguous_strides(x_shape), _contiguous_strides(B_shape),
                   _contiguous_strides(B_shape))
    aligned = (all(ptr % MMA_ALIGN == 0 for ptr in ptrs)
               and all(st[3] == 1 and all(s * dtype.itemsize % MMA_ALIGN == 0
                                          for s in st[:3])
                       for st in strides))
    smem = mma_smem_bytes(p, n, chunk)
    if (dtype == torch.bfloat16 and p in MMA_HEAD_DIMS and n in MMA_STATE_DIMS
            and p * n <= MMA_MAX_STATE and chunk % MMA_ROWS == 0
            and chunk <= MMA_MAX_CHUNK and smem <= MAX_SMEM and aligned):
        return Plan("mma", smem)
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head_dim {p} > {MAX_HEAD_DIM}")
    smem = smem_bytes(p, n, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan: p {p}, n {n}, chunk {chunk} need "
                         f"{smem} B of shared memory > {MAX_SMEM}")
    return Plan("cuda_core", smem)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def library_path(source: str = SOURCE) -> str:
    return nvcc.library_path(source)


def build(source: str = SOURCE) -> str:
    """Compile a kernel source unless a build of it exists; return the
    library path (``kernels.nvcc``)."""
    return nvcc.build(source)


def _load(source: str, entry: str, argtypes):
    lib = ctypes.CDLL(build(source))
    fn = getattr(lib, f"{entry}_forward")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{entry}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _load(SOURCE, "ssd_scan", _ARGS + [ctypes.c_int, ctypes.c_void_p])
    return _LIB


def _mma_library():
    global _MMA_LIB
    if _MMA_LIB is None:
        _MMA_LIB = _load(MMA_SOURCE, "ssd_scan_mma", _ARGS + [ctypes.c_void_p])
    return _MMA_LIB


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one block (the layout of csrc/ssd_scan.cu):
    the fp32 state [n][p], cumsum and dt [chunk] each, C and B tiles
    [TILE][n+1], an x tile [TILE][p] and a score tile [TILE][TILE+1]."""
    return 4 * (n * p + 2 * chunk + 2 * TILE * (n + 1) + TILE * p
                + TILE * (TILE + 1))


def _check(x, dt, A, B, C, D, chunk: int) -> Plan:
    """The plan for these tensors; raise ValueError unless a kernel takes
    them: shapes, types and strides first, then the device."""
    if x.dim() != 4 or B.dim() != 4 or C.dim() != 4 or dt.dim() != 3:
        raise ValueError("ssd_scan: x [b,l,h,p], dt [b,l,h], B/C [b,l,g,n]")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (C.shape != B.shape or B.shape[:2] != (b, l) or dt.shape != (b, l, h)
            or A.shape != (h,) or D.shape != (h,)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} C {tuple(C.shape)} "
                         f"D {tuple(D.shape)} do not agree")
    if min(b, l, h, p, g, n) == 0 or chunk <= 0 or l % chunk or h % g:
        raise ValueError(f"ssd_scan: l {l} must be a positive multiple of chunk "
                         f"{chunk} and h {h} a multiple of g {g}")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x {x.dtype}, B {B.dtype}, C {C.dtype}; "
                         "fp32 or bf16, all three alike")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} must be fp32, not {t.dtype}")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_scan: A and D must be contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"ssd_scan: {name} needs unit stride in its last dim")
    chosen = plan(x.shape, B.shape, x.dtype, chunk,
                  (x.stride(), B.stride(), C.stride()),
                  (x.data_ptr(), B.data_ptr(), C.data_ptr()))
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")
    return chosen


def ssd_scan(x, dt, A, B, C, D, chunk: int):
    """x [b,l,h,p] and B, C [b,l,g,n] (fp32 or bf16, alike, unit stride in the
    last dim, any other strides); dt [b,l,h], A, D [h] fp32; l % chunk == 0.

    Launches the kernel ``plan`` picks on PyTorch's current stream and
    returns (y [b,l,h,p], final state [b,h,p,n]), both contiguous in x's
    dtype. The inputs are read in place through their strides, so the slices
    of the conv output go in without a copy. Raises for tensors that are not
    on a CUDA device or that no kernel takes."""
    return launch(_check(x, dt, A, B, C, D, chunk), x, dt, A, B, C, D, chunk)


def launch(chosen: Plan, x, dt, A, B, C, D, chunk: int):
    """Launch the design ``chosen`` names on tensors ``_check`` has passed
    (``ssd_scan`` passes its plan; chip_smoke times the CUDA-core kernel on
    the inputs the plan sends to ``mma``). Counts the launch."""
    global LAUNCHES
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    mma = chosen.variant == "mma"
    lib = _mma_library() if mma else _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                b, l, h, p, g, n, chunk, chosen.smem,
                *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3])
        if mma:
            err = lib.ssd_scan_mma_forward(*args, stream)
            msg = lib.ssd_scan_mma_error_string
        else:
            err = lib.ssd_scan_forward(*args, _DTYPE_CODES[x.dtype], stream)
            msg = lib.ssd_scan_error_string
    if err:
        raise RuntimeError(f"ssd_scan {chosen.variant} kernel launch failed: "
                           f"{msg(err).decode()} ({err})")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[chosen.variant] += 1
    return y, state


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class SSDScan(torch.autograd.Function):
    """The SSD scan whose forward is the kernel and whose backward recomputes
    the plain version under autograd and differentiates that.

    The reference's Pallas kernel is forward-only (its training path on the
    CPU differentiates ``ssd_reference``), so there is no backward kernel to
    port. Nothing of the forward is saved but the inputs. The final state is
    the second output; training does not use it and its gradient comes in as
    None."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C, D, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(k) for t, k in zip(inputs, need)]
            y, state = ssd_plain(*ins, chunk=ctx.chunk, return_state=True)
            outs = [(o, go) for o, go in ((y, grad_y), (state, grad_state))
                    if go is not None]
            wrt = [t for t, k in zip(ins, need) if k]
            got = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                           [go for _, go in outs],
                                           allow_unused=True))
        return (*(next(got) if k else None for k in need), None)
