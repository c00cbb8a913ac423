"""Train step: loss → (micro-batched) grads → compression → clip → update
(``repro.train.step``, the single-device step; the manual-collectives step
comes with the distributed slice).

``make_train_step`` returns a function of (state, batch), as the reference
does, run eagerly. Gradients come from ``torch.autograd.grad`` with respect
to the parameter tensors (zeros for a parameter the loss does not reach);
the codec, clipping and the optimizer run without autograd. The step
updates the state it is given in place (parameters, optimizer moments,
error-feedback residuals), as the reference's jitted step donates its state
(``donate_argnums=(0,)``), so a full-width model's state is not held twice.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.dist.compression import compress_tree, init_error_feedback
from repro_torch.models import model as MD
from repro_torch.optim import clip_by_global_norm, make_optimizer, warmup_cosine
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ef: Any            # error-feedback buffers (grad compression) or None


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    params = MD.init_model(cfg, seed=seed, device=device)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    opt = opt_init(params, tcfg)
    ef = (init_error_feedback(params)
          if tcfg.grad_compression == "int8_ef" else None)
    return TrainState(params, opt, ef)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """``n`` batches of B // n rows each, in order."""
    def split(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} microbatches")
        return x.reshape(n, B // n, *x.shape[1:]).unbind(0)
    cols = {k: split(v) for k, v in batch.items()}
    return [{k: cols[k][i] for k in batch} for i in range(n)]


def _grad_fn(cfg: ModelConfig, tcfg: TrainConfig):
    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = MD.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                   remat=tcfg.remat_policy,
                                   ce_impl=tcfg.ce_impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)
    return loss_and_grads


def _loss_and_grads(grad_fn, params, batch, microbatches: int):
    """(loss, metrics, grads) with optional micro-batch accumulation.

    With ``microbatches <= 1`` grads keep their parameters' dtypes; the
    accumulated path returns fp32 grads, the mean over the microbatches."""
    if microbatches <= 1:
        return grad_fn(params, batch)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    losses, mlist = [], []
    for mb in _split_microbatches(batch, microbatches):
        loss, m, g = grad_fn(params, mb)
        acc = tree_map(lambda a, gg: a + gg.float() / microbatches, acc, g)
        losses.append(loss)
        mlist.append(m)
    metrics = {k: torch.stack([m[k].float() for m in mlist]).mean()
               for k in mlist[0]}
    return torch.stack(losses).mean(), metrics, acc


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics); the state that
    comes back holds the tensors of the one passed in, updated."""
    _, opt_update = make_optimizer(tcfg.optimizer)
    grad_fn = _grad_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        loss, metrics, grads = _loss_and_grads(grad_fn, params, batch,
                                               microbatches)

        # wire-format compression (numerics-exact w.r.t. a shared-scale
        # compressed all-reduce; see dist/compression.py)
        new_ef = state.ef
        if tcfg.grad_compression != "none":
            grads, new_ef = compress_tree(grads, tcfg.grad_compression,
                                          state.ef)

        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = warmup_cosine(state.opt.step, peak_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        new_params, new_opt = opt_update(params, grads, state.opt, tcfg, lr)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, loss=loss)
        return TrainState(new_params, new_opt, new_ef), metrics

    return train_step
