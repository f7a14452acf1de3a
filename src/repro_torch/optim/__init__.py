"""Optimizers and learning-rate schedules over the port's dict trees
(counterpart of the JAX package's ``optim/``)."""
from repro_torch.optim.optimizers import (adamw_init, adamw_update,
                                          momentum_init, momentum_update,
                                          sgd_update)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["adamw_init", "adamw_update", "momentum_init", "momentum_update",
           "sgd_update", "constant", "cosine_decay", "warmup_cosine"]
