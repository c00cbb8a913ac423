"""Flash attention forward: a hand-written CUDA kernel for Hopper, its
ctypes wrapper, its launch counter and its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel of
``repro.kernels.flash_attention``; the note at the top of the source says how.
It is compiled with ``nvcc`` for ``sm_90a`` at first use, from the repo's
source only, into ``kernels/build/`` (named by the source's hash, so an
edited source is rebuilt), and loaded with ``ctypes``.

``flash_attention`` launches the kernel on CUDA tensors and raises on any
other; ``attention_plain`` is the O(Sq·Skv) PyTorch counterpart of the
reference's ``attend_naive``. ``kernels.ops.attention`` picks between them by
the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from repro_torch.kernels import nvcc
from repro_torch.models.layers import NEG_INF, softcap

PAD_POS = 2 ** 30    # sentinel position for padded / empty KV slots
MAX_HEAD_DIM = 256

SOURCE = os.path.join(nvcc.CSRC, "flash_attention.cu")
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.NVCC_FLAGS

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0          # kernel launches since the last reset (plain int)
_LIB = None


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, spec) -> torch.Tensor:
    """[q, kv] fp32 additive bias: 0 where attendable, NEG_INF elsewhere.

    Slots holding the PAD_POS sentinel (empty ring-cache slots) are masked
    whatever the causality."""
    ok = kv_pos[None, :] < PAD_POS
    if spec.causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if spec.window:
        ok = ok & (kv_pos[None, :] > (q_pos[:, None] - spec.window))
    ok = ok.expand(q_pos.shape[0], kv_pos.shape[0])
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)


def attention_plain(q, k, v, q_pos, kv_pos, spec) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k,v: [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = spec.scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k.float()) * scale
    if spec.logit_softcap:
        s = softcap(s, spec.logit_softcap)
    s = s + mask_bias(q_pos, kv_pos, spec)[None, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


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
        fn = lib.flash_attention_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 18
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, q_pos, kv_pos) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, head_dim]")
    B, Sq, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Sq == 0 or Skv == 0 or B == 0:
        raise ValueError("flash_attention: empty q or kv")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads over {Hkv} kv heads")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}; fp32 or bf16, k and v alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride in head_dim")
        if max(t.stride()) >= 2 ** 31:
            raise ValueError(f"flash_attention: {name} strides exceed int32")
        if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned "
                             "(the kernel reads them in 16-byte chunks)")
    for name, t, n in (("q_pos", q_pos, Sq), ("kv_pos", kv_pos, Skv)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous int32 [{n}]")


def flash_attention(q, k, v, q_pos, kv_pos, spec) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k,v: [B,Skv,Hkv,hd]; q_pos [Sq], kv_pos [Skv] int32.

    Launches the CUDA kernel on PyTorch's current stream and returns
    [B,Sq,Hq,hd] in q's dtype. Raises for tensors that are not on a CUDA
    device or that the kernel does not take."""
    global LAUNCHES
    _check(q, k, v, q_pos, kv_pos)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    scale = spec.scale or 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale, int(spec.causal), int(spec.window),
            float(spec.logit_softcap), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k.dtype], stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the kernel and whose backward recomputes
    the plain version under autograd and differentiates that.

    The reference has no backward kernel either (its Pallas kernel is
    forward-only); its CPU path differentiates the blockwise attention
    under ``jax.checkpoint``, which recomputes it in the backward
    (``repro.models.attention.attend_blockwise``). So nothing of the
    forward is saved but the inputs, and the backward holds the O(Sq·Skv)
    scores of one call at a time. A backward kernel is later work.
    """

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, spec):
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.spec = spec
        return flash_attention(q, k, v, q_pos, kv_pos, spec)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
            out = attention_plain(*qkv, q_pos, kv_pos, ctx.spec)
            wrt = [t for t, n in zip(qkv, need) if n]
            got = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(got) if n else None for n in need), None, None, None)
