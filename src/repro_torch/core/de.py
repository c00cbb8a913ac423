"""Differential evolution in PyTorch, the population one tensor on the
device (``repro.core.de``).

The reference's algorithm, step for step: best1bin with the mutation
factor dithered in [0.5, 1) once a generation, crossover rate 0.7,
population popsize·M, ``r1, r2 ≠ i`` drawn by the skip trick, one forced
crossover gene (``jrand``), trials clipped to the bounds and accepted when
not worse (``≤``). Then a projected-Adam polish (lr 1e-3) through
autograd, kept only if it lowers the cost. Generations run as a Python
loop over whole-population tensor operations; random draws come from one
``torch.Generator`` on the device per seed.

The draws differ from ``jax.random``'s, so the two packages agree on the
cost they reach, not on x (as the reference's own jax and scipy backends).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


class DEResult(NamedTuple):
    x: torch.Tensor            # best member [M]
    fun: torch.Tensor          # best cost (0-d)
    population: torch.Tensor   # final population [NP, M]
    energies: torch.Tensor     # final costs [NP]
    n_gens: int


def _skip_self(r: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Map draws in [0, NP-1) to [0, NP) without member i."""
    return r + (r >= idx).long()


def _polish(cost: Callable, x: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, steps: int) -> torch.Tensor:
    """Projected Adam on cost(z), ``steps`` steps of lr 1e-3."""
    z = x.clone()
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    for t in range(1, steps + 1):
        zg = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(cost(zg), zg)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        z = torch.clamp(z - 1e-3 * mh / (torch.sqrt(vh) + 1e-9), lo, hi)
    return z


def differential_evolution_torch(cost_fn: Callable,
                                 bounds: Tuple[np.ndarray, np.ndarray], *,
                                 seed: int = 0, maxiter: int = 300,
                                 popsize: int = 15, recombination: float = 0.7,
                                 polish_steps: int = 500,
                                 device="cuda") -> DEResult:
    """Minimise ``cost_fn`` over the box ``bounds``. ``cost_fn`` maps
    x ``[..., M]`` to costs ``[...]`` (a population at once) and is
    differentiable for the polish."""
    dev = resolve_device(device)
    lo = torch.tensor(np.asarray(bounds[0]), dtype=torch.float32, device=dev)
    hi = torch.tensor(np.asarray(bounds[1]), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    M = lo.shape[0]
    NP = popsize * M
    idx = torch.arange(NP, device=dev)
    genes = torch.arange(M, device=dev)

    with torch.no_grad():
        pop = lo + (hi - lo) * torch.rand((NP, M), generator=gen, device=dev)
        energies = cost_fn(pop)
        for _ in range(maxiter):
            F = 0.5 + 0.5 * torch.rand((), generator=gen, device=dev)  # dither
            best = pop[torch.argmin(energies)]
            r1 = _skip_self(torch.randint(0, NP - 1, (NP,), generator=gen,
                                          device=dev), idx)
            r2 = _skip_self(torch.randint(0, NP - 1, (NP,), generator=gen,
                                          device=dev), idx)
            mutant = best[None, :] + F * (pop[r1] - pop[r2])        # best1
            cross = torch.rand((NP, M), generator=gen, device=dev) < recombination
            jrand = torch.randint(0, M, (NP,), generator=gen, device=dev)
            cross = cross | (genes[None, :] == jrand[:, None])
            trial = torch.clamp(torch.where(cross, mutant, pop), lo, hi)
            e_trial = cost_fn(trial)
            accept = e_trial <= energies
            pop = torch.where(accept[:, None], trial, pop)
            energies = torch.where(accept, e_trial, energies)
        best_i = torch.argmin(energies)
        x, fun = pop[best_i], energies[best_i]

    if polish_steps:
        xp = _polish(cost_fn, x, lo, hi, polish_steps)
        with torch.no_grad():
            fp = cost_fn(xp)
            better = fp < fun
            x = torch.where(better, xp, x)
            fun = torch.where(better, fp, fun)
    return DEResult(x, fun, pop, energies, maxiter)


def de_multi_seed(cost_fn: Callable, bounds, seeds: Sequence[int], *,
                  maxiter: int = 300, popsize: int = 15,
                  recombination: float = 0.7, polish_steps: int = 500,
                  device="cuda"):
    """One DE run per seed (each with its own generator)."""
    return [differential_evolution_torch(
        cost_fn, bounds, seed=s, maxiter=maxiter, popsize=popsize,
        recombination=recombination, polish_steps=polish_steps,
        device=device) for s in seeds]
