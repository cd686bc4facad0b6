"""Training of the port, named as in ``bigdl_tpu.optim``."""

from bigdl_tpu_torch.optim.optim_method import (
    SGD, Adam, OptimMethod, decayed_lr,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer, NonFiniteLossError, Optimizer,
)
from bigdl_tpu_torch.optim.trigger import Trigger

__all__ = ["Adam", "LocalOptimizer", "NonFiniteLossError", "OptimMethod",
           "Optimizer", "SGD", "Trigger", "decayed_lr"]
