"""Input placement of the sharded train step (``repro.launch.specs``'s
``batch_shardings``): each rank takes its rows of every batch leaf. The
reference's cache and state specs for sharded serving are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.dist.sharding import Mesh, batch_pspec, shard_of_full


def batch_shardings(batch: Dict[str, torch.Tensor],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of each leaf of a global batch: dim 0 split over the
    mesh's batch axes where it divides (``batch_pspec``), replicated over
    the others (views)."""
    return {k: shard_of_full(x, batch_pspec(mesh, x.ndim, int(x.shape[0])),
                             mesh)
            for k, x in batch.items()}
