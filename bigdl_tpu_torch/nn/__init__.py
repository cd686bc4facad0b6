"""Layers of the port (PyTorch), named as in ``bigdl_tpu.nn``."""

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.activation import GELU, LogSoftMax
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.containers import (
    CAddTable, ConcatTable, Identity, Remat, Sequential,
)
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, greedy_generate, install_decode_cache,
    reset_decode_slot, zero_decode_cache,
)
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomNormal, RandomUniform, Xavier,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNorm
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.nn.recurrent import TimeDistributed

__all__ = [
    "AbstractCriterion", "AbstractModule", "CAddTable", "ClassNLLCriterion",
    "ConcatTable", "Container", "CrossEntropyCriterion", "GELU",
    "Identity", "InitializationMethod", "LayerNorm", "Linear",
    "LogSoftMax", "LookupTable", "MultiHeadAttention", "RandomNormal",
    "RandomUniform", "Remat", "Sequential", "TensorModule", "TimeDistributed",
    "TimeDistributedCriterion", "Xavier", "assign_cache_slot",
    "cast_floating", "greedy_generate",
    "install_decode_cache", "reset_decode_slot", "zero_decode_cache",
]
