"""Gradient wire-format compression: bf16, int8, int8 + error feedback
(``repro.dist.compression``).

  * ``quantize_int8`` — symmetric max-abs int8 with a single fp32 scale;
    round-to-nearest, so |x - q·s| <= s/2 elementwise. On the card it runs
    as the CUDA kernels of ``kernels.quantize``, on the CPU as their plain
    versions (``kernels.ops``).
  * ``compress_decompress`` — one gradient through the wire format and
    back, with optional error feedback: the residual of step t is added to
    the gradient of step t+1.
  * ``compressed_psum_mean`` — a shared-scale all-reduce-mean over a
    ``torch.distributed`` process group in the wire format: the scale is
    agreed with a MAX all-reduce of the local max-abs, so every rank
    quantizes onto the same grid and the sum of the integers is exact.
  * ``compressed_psum_mean_ef`` — the same collective with per-rank error
    feedback: the residual stays on the rank that incurred it.
  * ``compressed_psum_mean_leaf`` / ``compressed_psum_mean_ef_leaf`` — the
    same over the tensors of one reference leaf on one scale (the sharded
    train step's gradient reduction).
  * ``compress_tree`` / ``init_error_feedback`` — the train step's tree
    plumbing.

The collectives are ``torch.distributed._functional_collectives`` calls
(``dist.sharding.all_reduce``), so ``torch.compile`` traces them into its
graph, and the int8 codec inside them goes through ``kernels.ops`` (the
absmax and quantize kernels on the card).
As in the reference, the integers are summed as fp32 values, which is what
the reference puts on its wire: sums of at most 8 values of magnitude ≤ 127
are exact integers, so the mean is bit-identical whatever the reduction
order. A group of ``None`` is a single rank: the codec runs, no collective.

One scale per reference leaf. The reference stacks the layers of a segment
into one ``[n_layers, ...]`` leaf and ``compress_tree`` quantizes each leaf
on one scale, the max-abs over all its layers; the port keeps one tensor per
layer, so ``compress_tree`` gathers them back by reference leaf
(``tree.reference_leaves``) and quantizes each group on one shared scale
(``compress_leaf``). A scale per layer tensor would be a different codec.

``WIRE_BITS`` maps each mode to its bits per value, the performance
model's compression extrinsic.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.distributed import ProcessGroup

from repro_torch.dist.sharding import all_reduce
from repro_torch.kernels import ops
from repro_torch.tree import (reference_leaves, tree_leaves, tree_map,
                              tree_unflatten)

COMPRESSIONS = ("none", "bf16", "int8", "int8_ef")

# Bits per value on the wire; the perf model's compression extrinsic.
WIRE_BITS = {"none": 32, "bf16": 16, "int8": 8, "int8_ef": 8}


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric max-abs quantization -> (int8 values, fp32 scale)."""
    return ops.quantize_int8(x)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return ops.dequantize_int8(q, scale)


def compress_leaf(gs: Sequence[torch.Tensor], mode: str,
                  errs: Optional[Sequence[torch.Tensor]] = None,
                  group: Optional[ProcessGroup] = None
                  ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """``compress_decompress`` of one reference leaf held as the tensors
    ``gs`` (its layers), quantized on one shared scale. Returns
    (decompressed, new_errs), both lists in ``gs``' order. Over ``group``
    the tensors are this rank's slices of a leaf spread over its ranks:
    the max-abs is agreed with a MAX all-reduce, so every slice is
    quantized on the whole leaf's scale (nothing else crosses ranks)."""
    if mode == "none":
        return list(gs), errs
    gfs = [g.float() for g in gs]
    if mode == "bf16":
        return [g.to(torch.bfloat16).float() for g in gfs], errs
    if mode not in ("int8", "int8_ef"):
        raise ValueError(f"unknown compression mode {mode!r}; "
                         f"have {COMPRESSIONS}")
    carried = (gfs if mode == "int8" or errs is None
               else [g + e.float() for g, e in zip(gfs, errs)])
    absmax = all_reduce(ops.absmax(*carried), "max", group)
    ds = [ops.dequantize_int8(*ops.quantize_with(c, absmax)) for c in carried]
    if mode == "int8":
        return ds, errs
    return ds, [c - d for c, d in zip(carried, ds)]


def compress_decompress(g: torch.Tensor, mode: str,
                        err: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Send ``g`` through the wire format; returns (decompressed, new_err).

    ``err`` is the error-feedback residual carried between steps (only
    used and updated in "int8_ef" mode; pass ``None`` for a fresh start).
    """
    ds, es = compress_leaf([g], mode, None if err is None else [err])
    return ds[0], None if es is None else es[0]


def group_size(group: Optional[ProcessGroup]) -> int:
    return 1 if group is None else group.size()


def _mean(summed: torch.Tensor, n: int) -> torch.Tensor:
    # a tensor divide, as the reference's ``/ psum(1.0)``; exact for n a
    # power of two, which every mesh axis of the sweep is
    return summed / torch.full((), float(n), device=summed.device)


def compressed_psum_mean(x: torch.Tensor, group: Optional[ProcessGroup],
                         mode: str = "int8") -> torch.Tensor:
    """All-reduce-mean of ``x`` over ``group`` in the wire format.

    int8 agrees the quantization grid across ranks with a MAX all-reduce
    of the local max-abs, so the integer sum is exact and only the shared
    scale carries rounding. int8_ef is refused: error feedback needs the
    residual threaded between steps (``compressed_psum_mean_ef``)."""
    return compressed_psum_mean_leaf([x], group, mode)[0]


def compressed_psum_mean_leaf(xs: Sequence[torch.Tensor],
                              group: Optional[ProcessGroup],
                              mode: str = "int8") -> List[torch.Tensor]:
    """``compressed_psum_mean`` of one reference leaf held as the tensors
    ``xs`` (its layers): in int8, one MAX all-reduce agrees the scale of
    the max-abs over all of them, as the reference's over its stacked leaf,
    then each tensor's integers are summed."""
    if mode == "int8_ef":
        raise ValueError("int8_ef needs a residual buffer — use "
                         "compressed_psum_mean_ef(x, group, err)")
    if mode not in ("none", "bf16", "int8"):
        raise ValueError(f"unknown compression mode {mode!r}")
    n = group_size(group)
    xfs = [x.float() for x in xs]
    if mode == "none":
        return [_mean(all_reduce(xf, "sum", group), n).to(x.dtype)
                for x, xf in zip(xs, xfs)]
    if mode == "bf16":
        return [_mean(all_reduce(xf.to(torch.bfloat16).float(), "sum", group),
                      n).to(x.dtype) for x, xf in zip(xs, xfs)]
    absmax = all_reduce(ops.absmax(*xfs), "max", group)
    out = []
    for x, xf in zip(xs, xfs):
        q, scale = ops.quantize_with(xf, absmax)
        summed = all_reduce(q.float(), "sum", group) * scale
        out.append(_mean(summed, n).to(x.dtype))
    return out


def compressed_psum_mean_ef(x: torch.Tensor, group: Optional[ProcessGroup],
                            err: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared-scale int8 all-reduce-mean with per-rank error feedback.

    ``carried = x + err`` is quantized on the MAX-agreed grid and
    ``new_err = carried − q·scale`` stays on this rank; only the integers
    and the shared scale cross the wire. Returns ``(mean, new_err)``."""
    (mean,), (new_err,) = compressed_psum_mean_ef_leaf([x], group, [err])
    return mean, new_err


def compressed_psum_mean_ef_leaf(xs: Sequence[torch.Tensor],
                                 group: Optional[ProcessGroup],
                                 errs: Sequence[torch.Tensor]
                                 ) -> Tuple[List[torch.Tensor],
                                            List[torch.Tensor]]:
    """``compressed_psum_mean_ef`` of one reference leaf held as the
    tensors ``xs`` with their residuals ``errs``, on one scale:
    (means, new residuals)."""
    n = group_size(group)
    carried = [x.float() + e.float() for x, e in zip(xs, errs)]
    absmax = all_reduce(ops.absmax(*carried), "max", group)
    means, new_errs = [], []
    for x, c in zip(xs, carried):
        q, scale = ops.quantize_with(c, absmax)
        qf = q.float()
        summed = all_reduce(qf, "sum", group) * scale
        means.append(_mean(summed, n).to(x.dtype))
        new_errs.append(c - qf * scale)
    return means, new_errs


def init_error_feedback(params):
    """fp32 zero residuals, one per parameter tensor."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_tree(grads, mode: str, ef=None,
                  group: Optional[ProcessGroup] = None):
    """``compress_decompress`` per reference leaf -> (new_grads, ef).
    ``group``: the tree holds this rank's slices of tensors spread over
    the group's ranks (``compress_leaf``).

    ``ef`` (when present) is the ``init_error_feedback`` tree; the new
    residuals are written into its tensors, and it comes back. In "int8_ef"
    mode a missing ``ef`` is initialized to zeros and returned, so the
    residual is never silently dropped — callers must thread it.
    """
    if mode in (None, "none"):
        return grads, ef
    if mode == "int8_ef" and ef is None:
        ef = init_error_feedback(grads)
    g_leaves = tree_leaves(grads)
    e_leaves = None if ef is None else tree_leaves(
        tree_map(lambda g, e: e, grads, ef))            # in grads' order
    new_g = list(g_leaves)
    for _, idx in reference_leaves(grads):
        errs = None if ef is None else [e_leaves[i] for i in idx]
        ds, es = compress_leaf([g_leaves[i] for i in idx], mode, errs, group)
        for j, i in enumerate(idx):
            new_g[i] = ds[j]
            if es is not None:
                e_leaves[i].copy_(es[j])
    return tree_unflatten(grads, new_g), ef
