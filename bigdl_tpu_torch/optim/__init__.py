"""Training of the port, named as in ``bigdl_tpu.optim``."""

from bigdl_tpu_torch.optim.distri_optimizer import (
    DistriOptimizer, ParallelOptimizer,
)
from bigdl_tpu_torch.optim.evaluator import Evaluator, Predictor
from bigdl_tpu_torch.optim.optim_method import (
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
    CompositeOptimMethod, Ftrl, LarsSGD, OptimMethod, RMSprop, decayed_lr,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer, NonFiniteLossError, Optimizer, TrainingPreempted,
)
from bigdl_tpu_torch.optim.regularizer import (
    L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer,
)
from bigdl_tpu_torch.optim.schedules import (
    Default, Exponential, LearningRateSchedule, MultiStep, NaturalExp,
    Plateau, Poly, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (
    MAE, NDCG, AccuracyResult, HitRatio, Loss, LossResult, MAPResult,
    MeanAveragePrecision, Top1Accuracy, Top5Accuracy, TopKAccuracy,
    TreeNNAccuracy, ValidationMethod, ValidationResult,
)

__all__ = ["AccuracyResult", "HitRatio", "Loss", "LossResult", "MAE",
           "MAPResult", "MeanAveragePrecision", "NDCG", "Top1Accuracy",
           "Top5Accuracy", "TopKAccuracy", "TreeNNAccuracy",
           "ValidationMethod", "ValidationResult",
           "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "CompositeOptimMethod", "Default", "DistriOptimizer",
           "Evaluator", "Exponential",
           "Ftrl",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer", "LBFGS",
           "LarsSGD", "LearningRateSchedule", "LocalOptimizer", "MultiStep",
           "NaturalExp", "NonFiniteLossError", "OptimMethod", "Optimizer",
           "ParallelOptimizer",
           "Plateau", "Poly", "Predictor", "RMSprop", "Regularizer", "SGD",
           "SequentialSchedule", "Step", "Trigger", "TrainingPreempted",
           "Warmup", "decayed_lr"]
