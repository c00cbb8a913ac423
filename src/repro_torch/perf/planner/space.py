"""The planner's search space (``repro.perf.planner.space``); so far only
``model_comm_sizes``, which the arch sweep prices its collectives with."""
from __future__ import annotations

from typing import Tuple


def model_comm_sizes(cfg, batch: int, seq: int,
                     skeleton=None) -> Tuple[int, int]:
    """(param_bytes, act_bytes) of an LM config: the schedule inputs the
    collectives are priced with. Parameter bytes are the model's tensors
    at their dtypes, read off ``models.model.param_shapes`` (tensors on the
    fake tensors: nothing is allocated or initialised), or off ``skeleton``,
    such a tree, when given. Activations are the tp block boundaries: one
    [batch, seq, d_model] fp32 tensor per layer (what Megatron-style
    schedules all-reduce)."""
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_leaves

    if skeleton is None:
        skeleton = MD.param_shapes(cfg)
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(skeleton))
    act_bytes = 4 * batch * seq * cfg.d_model * cfg.n_layers
    return param_bytes, act_bytes
