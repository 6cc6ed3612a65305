from repro_torch.train.loss import cross_entropy
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         global_norm, init_opt_state, lr_at)
from repro_torch.train.train_step import grad_step, loss_fn, train_step

__all__ = ["cross_entropy", "OptConfig", "init_opt_state", "adamw_update",
           "lr_at", "global_norm", "train_step", "grad_step", "loss_fn"]
