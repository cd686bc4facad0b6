"""Training of the port, named as in ``bigdl_tpu.optim``."""

from bigdl_tpu_torch.optim.optim_method import (
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
    CompositeOptimMethod, Ftrl, LarsSGD, OptimMethod, RMSprop, decayed_lr,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer, NonFiniteLossError, Optimizer,
)
from bigdl_tpu_torch.optim.regularizer import (
    L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer,
)
from bigdl_tpu_torch.optim.schedules import (
    Default, Exponential, LearningRateSchedule, MultiStep, NaturalExp,
    Plateau, Poly, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.trigger import Trigger

__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "CompositeOptimMethod", "Default", "Exponential", "Ftrl",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer", "LBFGS",
           "LarsSGD", "LearningRateSchedule", "LocalOptimizer", "MultiStep",
           "NaturalExp", "NonFiniteLossError", "OptimMethod", "Optimizer",
           "Plateau", "Poly", "RMSprop", "Regularizer", "SGD",
           "SequentialSchedule", "Step", "Trigger", "Warmup", "decayed_lr"]
