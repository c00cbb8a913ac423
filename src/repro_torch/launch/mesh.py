"""Mesh planning (``repro.train.ft``'s ``_factorizations`` and
``plan_remesh`` at its defaults): the (data, model) shape a world of ranks
is laid out as. ``plan_remesh``'s bounds on the model axis and its
perf-model ranking wait for the recovery planning that sets them; the rest
of ``ft.py`` (recovery planning, straggler detection) is not ported yet. A
mesh itself is ``dist.sharding.Mesh``, made on each rank by
``dist.pool.Pool.run``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple


def _factorizations(n: int) -> List[Tuple[int, int]]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append((d, n // d))
            if d != n // d:
                out.append((n // d, d))
        d += 1
    return sorted(out)


@dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    reason: str

    def axes(self) -> dict:
        """{axis: size}, as ``Pool.run`` takes a mesh."""
        return dict(zip(self.axis_names, self.mesh_shape))


def plan_remesh(n_devices: int) -> ElasticPlan:
    """(data, model) for ``n_devices`` ranks, as the reference's default
    (``min_model`` 1, no predictor): the count rounded down to a power of
    two, then its most square factorization (4 → (2, 2), 8 → (2, 4))."""
    if n_devices > 1:
        n_devices = 2 ** int(math.floor(math.log2(n_devices)))
    best = min(_factorizations(n_devices),
               key=lambda dm: abs(math.log2(dm[0]) - math.log2(dm[1])))
    return ElasticPlan(best, ("data", "model"), "most-square fallback")
