"""Mesh planning: the production meshes of the dry-run
(``make_production_mesh``) and the (data, model) shape a world of ranks is
laid out as. ``plan_remesh`` and ``ElasticPlan`` live in ``train.ft`` (with
the recovery planning that sets ``plan_remesh``'s model-axis bounds and its
perf-model ranking) and are re-exported here, where the port's entry points
import them, as the reference's ``launch.mesh`` sits beside its
``train.ft``. A mesh itself is ``dist.sharding.Mesh``, made on each rank by
``dist.pool.Pool.run``.
"""
from __future__ import annotations

from repro_torch.dist.sharding import LazyGroups, Mesh
from repro_torch.train.ft import ElasticPlan, _factorizations, plan_remesh

POD_AXES = {"data": 16, "model": 16}                    # 256 chips a pod
MULTIPOD_AXES = {"pod": 2, "data": 16, "model": 16}     # 512 chips


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The reference's production mesh, 16 × 16 ("data", "model") or, with
    ``multi_pod``, 2 × 16 × 16 ("pod", "data", "model"), as rank ``rank``
    of it sees it. Its process groups are made when the rank first asks for
    one (``LazyGroups``), so only in a world of that size: the dry-run's
    world on the ``"fake"`` backend."""
    return Mesh(MULTIPOD_AXES if multi_pod else POD_AXES, rank, LazyGroups())


__all__ = ["ElasticPlan", "_factorizations", "make_production_mesh",
           "plan_remesh"]
