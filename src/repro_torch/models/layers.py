"""Layer primitives over plain dicts of tensors (``repro.models.layers``: the
dense, MLP, norm, embedding and rope primitives, every activation of
``activation_fn``, and the Megatron ``tp_f`` / ``tp_g`` pair with the
``LocalDim`` and ``StreamDim`` markers of the manual sharded paths).

A dense layer is ``{"weight": [d_out, d_in], "bias": [d_out]}``, the
``F.linear`` layout; ``models.convert`` maps the reference's ``[d_in, d_out]``
kernels onto it. Initialisers draw from an explicit ``torch.Generator`` with
the reference's scales (its ``jax.random`` bits cannot be reproduced).

The reference keeps each parameter's logical axes on the leaf
(``Param.axes``); the port's tensors carry none. A sharded step that keeps
some dims local hands the layer functions a parallel tree ``axes`` (one
tuple of entries per tensor, in the port's layout, ``None`` when nothing
is marked), and the functions branch on its ``LocalDim`` entries as the
reference's branch on ``Param.axes``: a dense ``weight`` is ``[d_out,
d_in]``, so its output dim is entry 0 and its input dim entry -1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.distributed import ProcessGroup

from repro_torch.dist.sharding import all_reduce, axis_group

Params = Dict[str, torch.Tensor]

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking
GATED = ("silu", "geglu")  # MLP activations applied to a gate


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_param(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
                 scale: float) -> torch.Tensor:
    """``scale``·N(0, 1) drawn in fp32 on the generator's device, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype) -> Params:
    return {"table": normal_param(gen, (vocab, d), dtype, 0.02)}


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               bias: bool = False) -> Params:
    """Fan-in scaled normal weight ``[d_out, d_in]``; zero bias."""
    p = {"weight": normal_param(gen, (d_out, d_in), dtype,
                                1.0 / math.sqrt(max(d_in, 1)))}
    if bias:
        p["bias"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype) -> Params:
    """MLP weights (up, down), and a gate for the gated activations (silu,
    geglu)."""
    p = {"up": init_dense(gen, d_model, d_ff, dtype),
         "down": init_dense(gen, d_ff, d_model, dtype)}
    if activation in GATED:
        p["gate"] = init_dense(gen, d_model, d_ff, dtype)
    return p


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    return torch.tanh(x / cap) * cap


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


class _Unembed(torch.autograd.Function):
    """``x @ table.T`` accumulated and returned in fp32 from operands of any
    float dtype: the reference's ``preferred_element_type=float32``. On a
    CUDA device a bf16 GEMM with an fp32 output (``torch.mm(...,
    out_dtype=float32)``), so no fp32 copy of the table is made; on the CPU
    the operands are upcast. The backward rounds the cotangent to the
    operands' dtype and multiplies in it, as a product in that dtype
    followed by a cast to fp32 would."""

    @staticmethod
    def forward(x, table):
        x2 = x.reshape(-1, x.shape[-1])
        if x2.dtype == table.dtype == torch.float32:
            y = x2 @ table.t()
        elif x2.device.type == "cpu":
            y = x2.float() @ table.float().t()
        else:
            y = torch.mm(x2, table.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], table.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        gx = gt = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ table).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gt = g2.t() @ x.reshape(-1, x.shape[-1])
        return gx, gt


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ table.T`` in fp32, accumulated in fp32 and never rounded
    to the operands' dtype first (a final softcap applies to these values
    before ``logits_fn``'s bf16 cast)."""
    return _Unembed.apply(x, params["table"])


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, n, head_dim]; positions: broadcastable to [..., S]."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs      # [..., S, hd/2]
    angles = angles[..., None, :]                      # head axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation (approximate=True)
    return F.gelu(x, approximate="tanh")


def _sqrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


_ACTIVATIONS = {"silu": F.silu, "geglu": _gelu_tanh, "gelu": _gelu_tanh,
                "relu": torch.relu, "sqrelu": _sqrelu, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}


def activation_fn(name: str):
    """``repro.models.layers.activation_fn``: the MLP activations (silu and
    geglu gate the MLP; the gating is its structure) and LeNet's."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


def marks(axes, *keys):
    """The entries ``axes[k0][k1]...`` of a marker tree, or None."""
    for k in keys:
        if axes is None:
            return None
        axes = axes.get(k) if isinstance(axes, dict) else axes[k]
    return axes


def dense(params: Params, x: torch.Tensor, axes=None) -> torch.Tensor:
    """``x @ weight.T + bias``. A ``LocalDim`` on the weight's input dim
    makes it row-parallel: the partial products are summed over the
    marker's axis (``tp_g``) before the bias."""
    row = local_dim(marks(axes, "weight", -1))
    if row is None:
        return F.linear(x, params["weight"], params.get("bias"))
    y = tp_g(axis_group(row.axis), F.linear(x, params["weight"]))
    return y + params["bias"] if "bias" in params else y


def mlp(params: Params, x: torch.Tensor, activation: str,
        axes=None) -> torch.Tensor:
    """down(act(gate(x)) * up(x)) with a gate, else down(act(up(x))). A
    ``LocalDim`` on up's output dim (a column split of the hidden) enters
    through ``tp_f``; down's row split is closed by ``dense``."""
    act = activation_fn(activation)
    col = local_dim(marks(axes, "up", "weight", 0))
    if col is not None:
        x = tp_f(axis_group(col.axis), x)
    up = dense(params["up"], x)
    if "gate" in params:
        h = act(dense(params["gate"], x)) * up
    else:
        h = act(up)
    return dense(params["down"], h, marks(axes, "down"))


# ---------------------------------------------------------------------------
# Manual tensor parallelism (the sharded LeNet iteration's fc split)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LocalDim:
    """Axes-entry marker: this dimension holds a 1/``size`` *local* slice,
    split over the mesh axis ``axis`` (``logical`` is the dim's logical
    name). ``perf.sweep.lenet_partition_specs`` marks the split fc pair with
    it, and the overlap train step every dim it keeps model-local, one entry
    per dim of the port's layout."""
    logical: str
    axis: str
    size: int


def local_dim(entry) -> Optional[LocalDim]:
    return entry if isinstance(entry, LocalDim) else None


@dataclass(frozen=True)
class StreamDim:
    """Axes-entry marker: this dim is ZeRO-sharded and *streamed*: the
    overlap train step leaves the leaf sharded and each layer's body
    all-gathers it just before use (``dist.sharding.stream_gather``).
    ``entry`` is the dim's spec entry (a mesh-axis name or a tuple)."""
    logical: Optional[str]
    entry: Any


class _TpF(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # no_grad: the collective's own autograd formula is not one that
        # torch.func transforms can take, and nothing differentiates this
        with torch.no_grad():
            return all_reduce(g, "sum", ctx.group), None


class _TpG(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_f(group: ProcessGroup, x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce SUM backward over
    ``group``. It enters a partitioned sub-path, so the backward completes
    the partial input cotangents each model rank produces."""
    return _TpF.apply(x, group)


def tp_g(group: ProcessGroup, x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g``: all-reduce SUM forward over ``group``, identity
    backward. It closes a row-parallel product. A differentiable all-reduce
    (``torch.distributed.nn.functional.all_reduce``) would be wrong here:
    its backward all-reduces the already replicated output cotangent and so
    multiplies it by the ring size; the adjoint of "sum the partials" hands
    each rank the cotangent unchanged."""
    return _TpG.apply(x, group)
