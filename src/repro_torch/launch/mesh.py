"""Mesh planning: the (data, model) shape a world of ranks is laid out as.
``plan_remesh`` and ``ElasticPlan`` live in ``train.ft`` (with the
recovery planning that sets ``plan_remesh``'s model-axis bounds and its
perf-model ranking) and are re-exported here, where the port's entry points
import them, as the reference's ``launch.mesh`` sits beside its
``train.ft``. A mesh itself is ``dist.sharding.Mesh``, made on each rank by
``dist.pool.Pool.run``.
"""
from __future__ import annotations

from repro_torch.train.ft import ElasticPlan, _factorizations, plan_remesh

__all__ = ["ElasticPlan", "_factorizations", "plan_remesh"]
