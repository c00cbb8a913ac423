"""Optimizers over the port's parameter trees (``repro.optim.optimizers``).

AdamW and SGD are elementwise, so they run tensor by tensor. Adafactor is
not: its factored second moment of a stacked ``[n_layers, ...]`` reference
leaf averages over the leaf's last two axes (for a stacked norm scale
``[n_layers, d]`` that crosses layers) and its update clipping takes one RMS
over the whole leaf. So it stacks each reference leaf back into the
reference's layout (``tree.reference_leaves``; dense weights transposed to
``[d_in, d_out]``), updates it there and keeps its state in that layout.

Updates write into the parameters and the optimizer state they are given,
and return those same tensors: the counterpart of the reference's train
step, which donates its state, so a 2.6B-parameter model's update holds no
second copy of its parameters and moments. The arithmetic is the
reference's, element for element; only where the result lands differs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import reference_leaves, stack_dims, tree_leaves, tree_map


class OptState(NamedTuple):
    step: int        # updates applied so far (a host integer)
    mu: Any          # first moment (or momentum); tree or None
    nu: Any          # second moment; tree, adafactor's list, or None


def _state_dtype(tcfg: TrainConfig) -> torch.dtype:
    return getattr(torch, tcfg.opt_state_dtype)


def tree_global_norm(tree) -> torch.Tensor:
    """0-d fp32 tensor on the leaves' device."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def clip_by_global_norm(grads, max_norm: float):
    """Scale the tree to a global norm of at most ``max_norm``; each grad
    comes back in its own dtype. Returns (grads, norm)."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, tcfg: TrainConfig) -> OptState:
    dt = _state_dtype(tcfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(0, tree_map(zeros, params), tree_map(zeros, params))


def adamw_corrections(tcfg: TrainConfig, step: int) -> Tuple[float, float]:
    """AdamW's bias corrections (1 − b1^t, 1 − b2^t) for update ``step``
    (from 1), in fp32 on the host as the reference computes them."""
    return (float(np.float32(1.0) - np.float32(tcfg.beta1) ** np.float32(step)),
            float(np.float32(1.0) - np.float32(tcfg.beta2) ** np.float32(step)))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, tcfg: TrainConfig,
                 lr: float, corrections=None) -> Tuple[Any, OptState]:
    """``lr`` and ``corrections`` (``adamw_corrections`` of this update,
    computed from ``state.step`` when None) may be 0-d tensors: a compiled
    step passes them so that its graph does not hold the step count."""
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    step = state.step + 1
    c1, c2 = (adamw_corrections(tcfg, step) if corrections is None
              else corrections)

    def upd(p, g, m, v):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        update = update + wd * p.float()
        p.copy_(p.float() - lr * update)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, OptState(step, state.mu, state.nu)


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------

def sgd_init(params, tcfg: TrainConfig) -> OptState:
    dt = _state_dtype(tcfg)
    return OptState(0, tree_map(
        lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params), None)


@torch.no_grad()
def sgd_update(params, grads, state: OptState, tcfg: TrainConfig, lr: float):
    b1 = tcfg.beta1

    def upd(p, g, m):
        gf = g.float() + tcfg.weight_decay * p.float()
        m_new = b1 * m.float() + gf
        p.copy_(p.float() - lr * m_new)
        m.copy_(m_new)

    tree_map(upd, params, grads, state.mu)
    return params, OptState(state.step + 1, state.mu, None)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; for ≥100B runs)
# ---------------------------------------------------------------------------

def _to_reference(path, tensors, dims):
    """One reference leaf from the port's tensors: dense weights back to
    ``[d_in, d_out]``, segment layers stacked on the leading axes ``dims``
    (``tree.stack_dims``)."""
    ts = [t.float().transpose(-1, -2) if path[-1] == "weight" else t.float()
          for t in tensors]
    if not dims:
        return ts[0]
    return torch.stack(ts).reshape(dims + ts[0].shape)


def _from_reference(path, x, dims):
    xs = list(x.reshape((-1,) + x.shape[len(dims):]).unbind(0)) if dims else [x]
    return [t.transpose(-1, -2) if path[-1] == "weight" else t for t in xs]


def adafactor_init(params, tcfg: TrainConfig) -> OptState:
    """``nu``: one tuple per reference leaf (``tree.reference_leaves``
    order), ``(row, col)`` for a leaf of rank >= 2 and ``(full,)`` otherwise,
    in the reference's shapes."""
    leaves = tree_leaves(params)
    nu = []
    for path, idx in reference_leaves(params):
        ref = _to_reference(path, [leaves[i] for i in idx],
                            stack_dims(params, path))
        s, dev = ref.shape, ref.device
        if len(s) >= 2:
            nu.append((torch.zeros(s[:-1], device=dev),
                       torch.zeros(s[:-2] + s[-1:], device=dev)))
        else:
            nu.append((torch.zeros(s, device=dev),))
    return OptState(0, None, nu)


@torch.no_grad()
def adafactor_update(params, grads, state: OptState, tcfg: TrainConfig,
                     lr: float):
    """Each reference leaf is updated in the reference's stacked layout,
    then written back into the port's tensors and the factored moments."""
    eps = 1e-30
    step = state.step + 1
    decay = float(np.float32(1.0) - np.float32(step) ** np.float32(-0.8))
    leaves = tree_leaves(params)
    gleaves = tree_leaves(tree_map(lambda p, g: g, params, grads))
    for (path, idx), nu in zip(reference_leaves(params), state.nu):
        dims = stack_dims(params, path)
        gf = _to_reference(path, [gleaves[i] for i in idx], dims)
        g2 = gf * gf + eps
        if gf.dim() >= 2:
            row, col = nu
            row.copy_(decay * row + (1 - decay) * g2.mean(dim=-1))
            col.copy_(decay * col + (1 - decay) * g2.mean(dim=-2))
            rc = row / torch.clamp(row.mean(dim=-1, keepdim=True), min=eps)
            v = rc[..., None] * col[..., None, :]
        else:
            (v,) = nu
            v.copy_(decay * v + (1 - decay) * g2)
        update = gf / torch.sqrt(torch.clamp(v, min=eps))
        # update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
        update = update / torch.clamp(rms, min=1.0)
        p_ref = _to_reference(path, [leaves[i] for i in idx], dims)
        update = update + tcfg.weight_decay * p_ref
        new_p = p_ref - lr * update
        for i, t in zip(idx, _from_reference(path, new_p, dims)):
            leaves[i].copy_(t)
    return params, OptState(step, None, state.nu)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def make_optimizer(name: str) -> Tuple[Callable, Callable]:
    return {"adamw": (adamw_init, adamw_update),
            "sgd": (sgd_init, sgd_update),
            "adafactor": (adafactor_init, adafactor_update)}[name]
