"""Optimizers, schedules, gradient clipping over the port's parameter trees."""
from repro_torch.optim.optimizers import (OptState, adafactor_init, adamw_init,
                                          clip_by_global_norm, make_optimizer,
                                          sgd_init, tree_global_norm)
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["OptState", "adamw_init", "sgd_init", "adafactor_init",
           "make_optimizer", "clip_by_global_norm", "tree_global_norm",
           "warmup_cosine"]
