"""Flash attention forward: hand-written CUDA kernels for Hopper, their
ctypes wrapper, launch counters and plain PyTorch versions.

The kernels (``csrc/flash_attention.cu``) replace the Pallas TPU kernel of
``repro.kernels.flash_attention``; the note at the top of the source says how.
They are compiled with ``nvcc`` for ``sm_90a`` at first use, from the repo's
source only, into ``kernels/build/`` (named by the source's hash, so an
edited source is rebuilt), and loaded with ``ctypes``.

Three designs share one C entry; ``plan`` picks one per call from shapes and
dtypes alone (so it runs the same on the CPU):
- ``tile``: bf16, head_dim 64 or 128, more than 16 q rows per kv head
  (training, prefill): tensor-core tiles of 64 q rows;
- ``split_kv``: bf16, head_dim 64 or 128, at most 16 q rows per kv head
  (decode): the keys split over blocks, then ``split_kv_combine`` when
  there is more than one split;
- ``cuda_core``: everything else the kernels take (fp32 q or k/v, other head
  dims): fp32 products on CUDA cores.

``flash_attention`` launches on CUDA tensors and raises on any other;
``attention_plain`` is the O(Sq·Skv) PyTorch counterpart of the reference's
``attend_naive``, and ``attention_splitkv_plain`` mirrors the split-KV
kernel's partials and combine for the tests. ``kernels.ops.attention`` takes
the plain version for CPU tensors and ``attention`` (the
``repro_torch::flash_attention`` custom op, whose CPU implementation is the
plain version) for any other, eagerly and under ``torch.compile``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.models.layers import NEG_INF, softcap

PAD_POS = 2 ** 30    # sentinel position for padded / empty KV slots
MAX_HEAD_DIM = 256

SOURCE = os.path.join(nvcc.CSRC, "flash_attention.cu")
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.NVCC_FLAGS

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

VARIANTS = ("cuda_core", "tile", "split_kv", "split_kv_combine")
TC_HEAD_DIMS = (64, 128)     # head dims of the tensor-core kernels
DECODE_ROWS = 16             # q rows of a split-KV block: Sq * G at most this
KV_TILE = 64                 # keys per K/V tile; a split is a multiple of it
MIN_SPLIT = 128              # fewest keys a split takes
NUM_SMS = 132                # H100 SXM; the split count aims at 2 blocks an SM

LAUNCHES = 0          # flash_attention calls since the last reset (plain int)
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)   # kernel launches by design
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


def attention_splitkv_plain(q, k, v, q_pos, kv_pos, spec, n_splits: int) -> torch.Tensor:
    """The split-KV kernel's algorithm in plain PyTorch, fp32 inside (tests
    only). Split i holds keys [i·L, (i+1)·L) ∩ [0, Skv), L =
    ``split_len_for(Skv, n_splits)``, and keeps (acc, m, l): m is its max
    score (masked keys score the finite NEG_INF, so a split of masked keys has
    m = NEG_INF; a split with no key has m = -inf, l = 0, acc = 0). The
    combine weights split i by exp(m_i - max m), and by 0 where m_i = -inf."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = spec.scale or 1.0 / math.sqrt(hd)
    length = split_len_for(Skv, n_splits)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    bias = mask_bias(q_pos, kv_pos, spec)
    parts = []
    for i in range(n_splits):
        lo, hi = min(i * length, Skv), min((i + 1) * length, Skv)
        if lo == hi:
            parts.append(None)
            continue
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, k[:, lo:hi].float()) * scale
        if spec.logit_softcap:
            s = softcap(s, spec.logit_softcap)
        s = s + bias[:, lo:hi]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        acc = torch.einsum("bkgqt,btkh->bkgqh", p, v[:, lo:hi].float())
        parts.append((acc, m, p.sum(dim=-1, keepdim=True)))
    m_all = torch.stack([m for _, m, _ in filter(None, parts)]).amax(dim=0)
    acc = torch.zeros(B, Hkv, G, Sq, hd, device=q.device)
    den = torch.zeros(B, Hkv, G, Sq, 1, device=q.device)
    for part in parts:
        if part is None:          # m = -inf: weight 0
            continue
        a, m, l = part
        w = torch.exp(m - m_all)
        acc, den = acc + w * a, den + w * l
    o = (acc / den).permute(0, 3, 1, 2, 4)      # [B, Sq, Hkv, G, hd]
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Plan: which kernel, and how the keys are split
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    variant: str            # "cuda_core", "tile" or "split_kv"
    n_splits: int = 1       # split_kv: blocks along the keys of a kv head
    split_len: int = 0      # split_kv: keys per split, a multiple of KV_TILE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_len_for(Skv: int, n_splits: int) -> int:
    """Keys per split for ``n_splits`` splits: Skv / n_splits rounded up to
    whole K/V tiles (so the last splits may hold fewer keys, or none: the
    plain mirror takes any count, ``plan`` only counts that leave none empty)."""
    return _cdiv(_cdiv(Skv, n_splits), KV_TILE) * KV_TILE


def plan(q_shape, kv_shape, q_dtype, k_dtype, v_dtype) -> Plan:
    """The kernel design for q [B,Sq,Hq,hd] and k/v [B,Skv,Hkv,hd]; raises
    ValueError for what no design takes. A split-KV call gets splits of at
    least MIN_SPLIT keys, as many as give ~2 blocks an SM, none of them empty."""
    B, Sq, Hq, hd = q_shape
    Bk, Skv, Hkv, hdk = kv_shape
    if Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: k/v {tuple(kv_shape)} do not match "
                         f"q {tuple(q_shape)}")
    if Sq == 0 or Skv == 0 or B == 0:
        raise ValueError("flash_attention: empty q or kv")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads over {Hkv} kv heads")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    if q_dtype not in _DTYPE_CODES or k_dtype not in _DTYPE_CODES or v_dtype != k_dtype:
        raise ValueError(f"flash_attention: dtypes q {q_dtype}, k {k_dtype}, "
                         f"v {v_dtype}; fp32 or bf16, k and v alike")
    if q_dtype != torch.bfloat16 or k_dtype != torch.bfloat16 or hd not in TC_HEAD_DIMS:
        return Plan("cuda_core")
    if Sq * (Hq // Hkv) > DECODE_ROWS:
        return Plan("tile")
    length = max(MIN_SPLIT, split_len_for(Skv, _cdiv(2 * NUM_SMS, B * Hkv)))
    return Plan("split_kv", _cdiv(Skv, length), length)


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
                          ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_VARIANT_CODES = {"cuda_core": 0, "tile": 1, "split_kv": 2}


def _check(q, k, v, q_pos, kv_pos) -> Plan:
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, head_dim]")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    p = plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride in head_dim")
        if max(t.stride()) >= 2 ** 31:
            raise ValueError(f"flash_attention: {name} strides exceed int32")
        if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned "
                             "(the kernel reads them in 16-byte chunks)")
    for name, t, n in (("q_pos", q_pos, q.shape[1]), ("kv_pos", kv_pos, k.shape[1])):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous int32 [{n}]")
    return p


def flash_attention(q, k, v, q_pos, kv_pos, spec) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k,v: [B,Skv,Hkv,hd]; q_pos [Sq], kv_pos [Skv] int32.

    Launches the kernel ``plan`` picks on PyTorch's current stream and
    returns [B,Sq,Hq,hd] in q's dtype. Raises for tensors that are not on a
    CUDA device or that no kernel takes."""
    global LAUNCHES
    p = _check(q, k, v, q_pos, kv_pos)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if p.n_splits > 1:      # fp32 partials of each split, merged by the combine
        part_acc = torch.empty((B * Hkv, p.n_splits, DECODE_ROWS, hd),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B * Hkv, p.n_splits, 2, DECODE_ROWS),
                              dtype=torch.float32, device=q.device)
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
            _DTYPE_CODES[k.dtype], _VARIANT_CODES[p.variant], p.split_len,
            p.n_splits, None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {p.variant} kernel launch failed: "
                           f"{msg} ({err})")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[p.variant] += 1
    if p.n_splits > 1:
        LAUNCHES_BY_VARIANT["split_kv_combine"] += 1
    return out


def plain_grads(q, k, v, q_pos, kv_pos, spec, grad_out, need=(True,) * 3):
    """The grads of q, k, v (those ``need`` asks for) of ``attention_plain``
    against ``grad_out``, recomputed under autograd: the backward of the
    ``repro_torch::flash_attention`` op.

    The reference has no backward kernel either (its Pallas kernel is
    forward-only); its CPU path differentiates the blockwise attention
    under ``jax.checkpoint``, which recomputes it in the backward
    (``repro.models.attention.attend_blockwise``). So nothing of the
    forward is saved but the inputs, and the backward holds the O(Sq·Skv)
    scores of one call at a time. A backward kernel is later work."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
        out = attention_plain(*qkv, q_pos, kv_pos, spec)
        wrt = [t for t, n in zip(qkv, need) if n]
        return torch.autograd.grad(out, wrt, grad_out)


# ---------------------------------------------------------------------------
# The custom op: what the model calls
# ---------------------------------------------------------------------------
#
# ``repro_torch::flash_attention`` is the forward as a ``torch.library``
# custom op, what every call on the card goes through, eager or compiled: a
# ``torch.compile(fullgraph=True)`` graph of a train step holds it as one
# node. Its CUDA implementation is ``flash_attention`` (the kernel, counted
# in the launch counters on every call of the compiled code too, since the
# count is inside the implementation), its CPU implementation the plain
# version. Its backward is the plain recompute (``plain_grads``) of the
# inputs that need a grad, on either device: plain PyTorch that a compiled
# graph's backward holds op by op. The spec travels as its four fields.

class _Spec(NamedTuple):
    causal: bool
    window: int
    logit_softcap: float
    scale: float


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                       window: int, logit_softcap: float, scale: float
                       ) -> torch.Tensor:
    """The kernel on any device but the CPU (it launches or raises)."""
    return flash_attention(q, k, v, q_pos, kv_pos,
                           _Spec(causal, window, logit_softcap, scale))


@flash_attention_op.register_kernel("cpu")
def _(q, k, v, q_pos, kv_pos, causal, window, logit_softcap, scale):
    return attention_plain(q, k, v, q_pos, kv_pos,
                           _Spec(causal, window, logit_softcap, scale)
                           ).contiguous()


@flash_attention_op.register_fake
def _(q, k, v, q_pos, kv_pos, causal, window, logit_softcap, scale):
    return q.new_empty(q.shape)              # contiguous, as the kernel's


def _op_setup_context(ctx, inputs, output):
    q, k, v, q_pos, kv_pos, *ctx.spec = inputs
    ctx.save_for_backward(q, k, v, q_pos, kv_pos)


def _op_backward(ctx, grad_out):
    q, k, v, q_pos, kv_pos = ctx.saved_tensors
    need = ctx.needs_input_grad[:3]
    got = iter(plain_grads(q, k, v, q_pos, kv_pos, _Spec(*ctx.spec), grad_out,
                           need))
    return (*(next(got) if n else None for n in need), *(None,) * 6)


flash_attention_op.register_autograd(_op_backward,
                                     setup_context=_op_setup_context)


def attention(q, k, v, q_pos, kv_pos, spec) -> torch.Tensor:
    """``repro_torch::flash_attention`` with ``spec`` (an ``AttnSpec``)."""
    return flash_attention_op(q, k, v, q_pos, kv_pos, bool(spec.causal),
                              int(spec.window), float(spec.logit_softcap),
                              float(spec.scale))
