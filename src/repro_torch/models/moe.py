"""Mixture-of-experts block: top-k routing, sort-based capacity dispatch
(``repro.models.moe``, the single-device path).

Tokens are ranked within their expert by a stable sort of the (token, k)
slots' expert ids; a slot whose rank reaches the capacity C goes to one
extra overflow row of the ``[E·C + 1, D]`` dispatch buffer, which is dropped,
and its weight with it. The expert FFN is one batched product over the
``[E, C, D]`` buffer (gated silu), then the kept slots are gathered back and
combined with their routing weights in fp32. The router runs in fp32 and
returns the Switch load-balance loss.

The reference computes all of this outside any Pallas kernel, so the port
has no kernel here either. Under the overlap train step the expert FFN runs
tensor-parallel (``LocalDim`` markers): expert-local (this rank owns E/m
experts) or ff-column (every expert's hidden split, ``w_down`` row-parallel).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, ModelConfig
from repro_torch.dist.sharding import axis_group, axis_index
from repro_torch.models.layers import (Params, dense, init_dense, local_dim,
                                       marks, normal_param, tp_f, tp_g,
                                       tp_probe)


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The router, an fp32 ``[d, E]`` array; the experts, stacked arrays
    ``w_gate``/``w_up`` ``[E, d, ff]`` and ``w_down`` ``[E, ff, d]`` in the
    reference's layout; the shared expert, three dense layers. The stacked
    arrays take the reference's ``make_param`` scale, 1/sqrt of their first
    axis, which for the experts is E."""
    e: MoEConfig = cfg.moe
    d, E, ff = cfg.d_model, e.n_experts, e.d_ff_expert
    p = {
        "router": normal_param(gen, (d, E), torch.float32, 1.0 / math.sqrt(d)),
        "w_gate": normal_param(gen, (E, d, ff), dtype, 1.0 / math.sqrt(E)),
        "w_up": normal_param(gen, (E, d, ff), dtype, 1.0 / math.sqrt(E)),
        "w_down": normal_param(gen, (E, ff, d), dtype, 1.0 / math.sqrt(E)),
    }
    if e.n_shared_experts:
        ffs = (e.d_ff_shared or e.d_ff_expert) * e.n_shared_experts
        p["shared"] = {"gate": init_dense(gen, d, ffs, dtype),
                       "up": init_dense(gen, d, ffs, dtype),
                       "down": init_dense(gen, ffs, d, dtype)}
    return p


def topk_route(logits: torch.Tensor, e: MoEConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [T, E] -> (weights [T, k] fp32, ids [T, k], aux loss).

    The top k come from a stable descending sort, so equal probabilities
    go to the lower expert id first, as ``lax.top_k`` breaks ties."""
    probs = torch.softmax(logits.float(), dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = srt[:, :e.top_k], order[:, :e.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)   # renormalise
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    T = logits.shape[0]
    counts = expert_counts(ids.reshape(-1), e.n_experts).float()
    f = counts / (T * e.top_k)
    P = probs.mean(dim=0)
    aux = e.n_experts * torch.sum(f * P) * e.aux_loss_weight
    return w, ids, aux


def expert_counts(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Slots routed to each expert, [n_experts] int64: ``bincount`` with a
    shape that does not depend on the ids (a dry-run traces it on fake
    tensors)."""
    return torch.zeros(n_experts, dtype=torch.int64, device=flat_ids.device
                       ).scatter_add_(0, flat_ids, torch.ones_like(flat_ids))


def expert_ranks(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """rank[i] = the number of earlier slots routed to slot i's expert."""
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    counts = expert_counts(flat_ids, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty_like(flat_ids)
    ranks[order] = torch.arange(n, device=flat_ids.device) - starts[flat_ids[order]]
    return ranks


def expert_capacity(e: MoEConfig, T: int) -> int:
    """Slots per expert for T tokens: ceil(int(cf·T·k) / E), at least 1."""
    return max(1, -(-int(e.capacity_factor * T * e.top_k) // e.n_experts))


class _Combine(torch.autograd.Function):
    """y[t] = sum_j wk[t, j] · slot[t, j] in fp32, from fp32 weights and slot
    rows of any float dtype (the reference's ``preferred_element_type``).
    Only the operands are kept for the backward: the fp32 copy of the
    ``[T, k, D]`` slots lives within one pass, never between them."""

    @staticmethod
    def forward(wk, slot):
        return torch.bmm(wk[:, None, :], slot.float())[:, 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        wk, slot = ctx.saved_tensors
        gw = gs = None
        if ctx.needs_input_grad[0]:
            gw = torch.bmm(slot.float(), g[:, :, None])[..., 0]
        if ctx.needs_input_grad[1]:
            gs = (wk[:, :, None] * g[:, None, :]).to(slot.dtype)
        return gw, gs


def moe_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                axes=None) -> MoEOut:
    """x [B, S, D] -> MoEOut(y [B, S, D] in x's dtype, aux loss).

    A ``LocalDim`` on w_gate's expert dim: this rank's E/m experts run on
    their rows of the dispatch buffer, and the other rows' outputs are
    zeros summed in by ``tp_g``; on its ff dim: every expert's hidden is a
    column slice and w_down's partial products are summed. Either way only
    the dispatch enters through ``tp_f``: the router and the combine stay on
    the unwrapped tokens, whose cotangent is complete on every rank."""
    e = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, e.top_k, e.n_experts
    xt = x.reshape(T, D)
    w, ids, aux = topk_route(xt.float() @ params["router"], e)

    C = expert_capacity(e, T)
    flat_ids = ids.reshape(-1)                                  # [T*k]
    ranks = expert_ranks(flat_ids, E)
    keep = ranks < C
    dest = torch.where(keep, flat_ids * C + ranks, torch.full_like(flat_ids, E * C))

    # scatter token rows into per-expert buffers (+1 overflow row); each
    # kept slot owns its row, so only the discarded overflow row sums
    ex = local_dim(marks(axes, "w_gate", 0))
    ff_col = local_dim(marks(axes, "w_gate", 2))
    disp = xt
    if ex is not None:
        disp = tp_f(axis_group(ex.axis), disp)
    elif ff_col is not None:
        disp = tp_f(axis_group(ff_col.axis), disp)
    rows = disp.repeat_interleave(k, dim=0)                     # [T*k, D]
    buf = xt.new_zeros(E * C + 1, D).index_add(0, dest, rows)
    h = buf[:E * C].view(E, C, D)

    # batched expert FFN (gated silu in every MoE arch)
    if ex is not None:
        e_loc = E // ex.size
        h = h[axis_index(ex.axis) * e_loc:][:e_loc]
    g = tp_probe("moe_hidden", torch.bmm(h, params["w_gate"]))
    u = torch.bmm(h, params["w_up"])
    out = torch.bmm(F.silu(g) * u, params["w_down"])
    if ex is not None:
        r = axis_index(ex.axis)
        out = tp_g(axis_group(ex.axis), F.pad(
            out, (0, 0, 0, 0, r * e_loc, E - (r + 1) * e_loc)))
    elif ff_col is not None:
        out = tp_g(axis_group(ff_col.axis), out)

    # gather back and combine with the routing weights (dropped -> 0), the
    # k-weighted sum accumulated in fp32
    slot_out = torch.where(keep[:, None],
                           out.view(E * C, D)[torch.clamp(dest, max=E * C - 1)],
                           torch.zeros((), dtype=out.dtype, device=out.device))
    wk = w * keep.view(T, k)
    y = _Combine.apply(wk, slot_out.view(T, k, D))
    y = y * e.routed_scaling

    if "shared" in params:
        sh, sax = params["shared"], marks(axes, "shared")
        xs = xt
        col = local_dim(marks(sax, "gate", "weight", 0))
        if col is not None:
            xs = tp_f(axis_group(col.axis), xs)
        hs = F.silu(dense(sh["gate"], xs)) * dense(sh["up"], xs)
        y = y + dense(sh["down"], hs, marks(sax, "down")).float()
    return MoEOut(y.to(x.dtype).view(B, S, D), aux)
