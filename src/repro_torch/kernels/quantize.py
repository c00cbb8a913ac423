"""The int8 wire codec: three hand-written CUDA kernels for Hopper, their
ctypes wrappers, launch counters and plain PyTorch versions.

The kernels (``csrc/quantize.cu``) replace the Pallas TPU kernels of
``repro.kernels.quantize``; the note at the top of the source says how. The
codec is symmetric max-abs int8 with one fp32 scale, ``s = max|x| / 127``,
``q = int8(clip(round_half_even(x / s), ±127))`` (a true divide, and 1 in
place of a zero scale), ``x̂ = q · s``; bit-identical to the reference's eager
jnp codec (``repro.dist.compression``).

The max-abs is split from the quantize step so that several tensors can
share one scale: ``absmax_into`` accumulates max|x| of a tensor into a
device scalar from ``new_absmax``, and ``quantize_with`` quantizes against
what that scalar holds. The port's parameter trees keep a stacked reference
leaf as one tensor per layer, and the reference's scale is one per stacked
leaf (``dist.compression.compress_tree``).

Wrappers launch on PyTorch's current stream, count their launches and raise
for tensors that are not on a CUDA device; the ``*_plain`` functions are
the same arithmetic in PyTorch, which ``kernels.ops`` takes for CPU tensors.
``absmax_into`` and ``quantize_with`` are registered as ``torch.library``
custom ops (``repro_torch::quantize_absmax``, ``repro_torch::quantize_int8``)
with fake versions for tracing, so a ``torch.compile(fullgraph=True)`` graph,
such as the sharded LeNet iteration's (``perf.sweep``), keeps them as extern
calls to these wrappers: the checks, the launch and the count run on every
call of the compiled code too.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from repro_torch.kernels import nvcc

SOURCE = os.path.join(nvcc.CSRC, "quantize.cu")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain ints)
ABSMAX_LAUNCHES = 0
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0
_LIB = None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """max|x| over all elements, a 0-d fp32 tensor."""
    return torch.amax(torch.abs(x.float()))


def quantize_plain(x: torch.Tensor, absmax: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q of x's shape, 0-d fp32 scale) for the given max-abs.

    Both divides are tensor by tensor: PyTorch turns a divide by a Python
    scalar on the card into a multiply by its reciprocal, which is not the
    reference's codec at half-ulp boundaries."""
    scale = absmax.reshape(()) / torch.full((), 127.0, device=absmax.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x.float() / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.reshape(())


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def library_path() -> str:
    return nvcc.library_path(SOURCE)


def build() -> str:
    """Compile the kernels unless a build of this source exists; return the
    library path (``kernels.nvcc``)."""
    return nvcc.build(SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.quantize_absmax.argtypes = [vp, ll, i, i, vp, i, vp]
        lib.quantize_int8.argtypes = [vp, ll, i, i, vp, vp, vp, i, vp]
        lib.dequantize_int8.argtypes = [vp, ll, i, vp, vp, i, vp]
        for fn in (lib.quantize_absmax, lib.quantize_int8, lib.dequantize_int8):
            fn.restype = ctypes.c_int
        lib.quantize_error_string.argtypes = [ctypes.c_int]
        lib.quantize_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.quantize_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(what: str, x: torch.Tensor, dtypes, scalar: torch.Tensor) -> None:
    for name, t in (("input", x), ("scalar", scalar)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
    if scalar.device != x.device:
        raise ValueError(f"{what}: scalar on {scalar.device}, input on {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {x.dtype}; takes {list(dtypes)}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{what}: input must be contiguous and non-empty")
    if (scalar.dtype != torch.float32 or scalar.numel() != 1
            or not scalar.is_contiguous()):
        raise ValueError(f"{what}: scalar must be one contiguous fp32 value")


def _aligned(*ts) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def new_absmax(device) -> torch.Tensor:
    """A zeroed fp32 device scalar for ``absmax_into`` to accumulate into."""
    return torch.zeros(1, dtype=torch.float32, device=device)


@torch.library.custom_op("repro_torch::quantize_absmax", mutates_args=("absmax",))
def absmax_into(x: torch.Tensor, absmax: torch.Tensor) -> None:
    """absmax ← max(absmax, max|x|), on the device (fp32 or bf16 x)."""
    global ABSMAX_LAUNCHES
    _check("quantize_absmax", x, _DTYPE_CODES, absmax)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_absmax(x.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype],
                                  _aligned(x), absmax.data_ptr(),
                                  _sm_count(x.device), stream)
    _raise_on(lib, err, "quantize_absmax")
    ABSMAX_LAUNCHES += 1


@absmax_into.register_fake
def _(x, absmax):
    return None


@torch.library.custom_op("repro_torch::quantize_int8", mutates_args=())
def quantize_with(x: torch.Tensor, absmax: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q of x's shape, 0-d fp32 scale = absmax / 127) against the
    max-abs that the device scalar ``absmax`` holds."""
    global QUANTIZE_LAUNCHES
    _check("quantize_int8", x, _DTYPE_CODES, absmax)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_int8(x.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype],
                                _aligned(x, q), absmax.data_ptr(),
                                scale.data_ptr(), q.data_ptr(),
                                _sm_count(x.device), stream)
    _raise_on(lib, err, "quantize_int8")
    QUANTIZE_LAUNCHES += 1
    return q, scale


@quantize_with.register_fake
def _(x, absmax):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty((), dtype=torch.float32, device=x.device))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 q · scale, of q's shape."""
    global DEQUANTIZE_LAUNCHES
    _check("dequantize_int8", q, (torch.int8,), scale)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequantize_int8(q.data_ptr(), q.numel(), _aligned(q, out),
                                  scale.data_ptr(), out.data_ptr(),
                                  _sm_count(q.device), stream)
    _raise_on(lib, err, "dequantize_int8")
    DEQUANTIZE_LAUNCHES += 1
    return out
