"""Mamba2 SSD chunked scan: a hand-written CUDA kernel for Hopper, its ctypes
wrapper, its launch counter, its autograd Function and its plain PyTorch
version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel of
``repro.kernels.ssd_scan``; the note at the top of the source says how. It is
compiled with ``nvcc`` for ``sm_90a`` at first use, from the repo's source
only, into ``kernels/build/``, and loaded with ``ctypes``.

``ssd_scan`` launches the kernel on CUDA tensors and raises on any other;
``ssd_plain`` is the PyTorch counterpart of the reference's
``repro.models.ssm.ssd_reference``, with its dtype flow: in bf16 the C·Bᵀ
product and the carried state are rounded to bf16 where the reference rounds
them, while the kernel keeps both in fp32 as the Pallas kernel does, so the
two differ by more than the rounding of y in bf16. ``kernels.ops.ssd_chunked``
picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels import nvcc

SOURCE = os.path.join(nvcc.CSRC, "ssd_scan.cu")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                 # q / k rows per tile (csrc/ssd_scan.cu kTile)
MAX_HEAD_DIM = 128        # P (kMaxP): the y tile a block's threads hold
MAX_SMEM = 232448         # bytes of shared memory a block may use on an H100

LAUNCHES = 0              # kernel launches since the last reset (plain int)
_LIB = None


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


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def library_path() -> str:
    return nvcc.library_path(SOURCE)


def build() -> str:
    """Compile the kernel unless a build of this source exists; return the
    library path (``kernels.nvcc``)."""
    return nvcc.build(SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        fn = lib.ssd_scan_forward
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one block (the layout of csrc/ssd_scan.cu):
    the fp32 state [n][p], cumsum and dt [chunk] each, C and B tiles
    [TILE][n+1], an x tile [TILE][p] and a score tile [TILE][TILE+1]."""
    return 4 * (n * p + 2 * chunk + 2 * TILE * (n + 1) + TILE * p
                + TILE * (TILE + 1))


def _check(x, dt, A, B, C, D, chunk: int) -> None:
    """Raise ValueError unless the kernel takes these tensors: shapes, types
    and strides first, then the device."""
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
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head_dim {p} > {MAX_HEAD_DIM}")
    if smem_bytes(p, n, chunk) > MAX_SMEM:
        raise ValueError(f"ssd_scan: p {p}, n {n}, chunk {chunk} need "
                         f"{smem_bytes(p, n, chunk)} B of shared memory > {MAX_SMEM}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")


def ssd_scan(x, dt, A, B, C, D, chunk: int):
    """x [b,l,h,p] and B, C [b,l,g,n] (fp32 or bf16, alike, unit stride in the
    last dim, any other strides); dt [b,l,h], A, D [h] fp32; l % chunk == 0.

    Launches the CUDA kernel on PyTorch's current stream and returns
    (y [b,l,h,p], final state [b,h,p,n]), both contiguous in x's dtype. The
    inputs are read in place through their strides, so the slices of the
    conv output go in without a copy. Raises for tensors that are not on a
    CUDA device or that the kernel does not take."""
    global LAUNCHES
    _check(x, dt, A, B, C, D, chunk)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_forward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, l, h, p, g, n, chunk, smem_bytes(p, n, chunk),
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            _DTYPE_CODES[x.dtype], stream)
    if err:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
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
