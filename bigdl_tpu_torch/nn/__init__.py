"""Layers of the port (PyTorch), named as in ``bigdl_tpu.nn``."""

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.activation import GELU, LogSoftMax
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.containers import (
    CAddTable, ConcatTable, Identity, Sequential,
)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, greedy_generate, install_decode_cache,
    reset_decode_slot,
)
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomNormal, RandomUniform, Xavier,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNorm
from bigdl_tpu_torch.nn.recurrent import TimeDistributed

__all__ = [
    "AbstractModule", "CAddTable", "ConcatTable", "Container", "GELU",
    "Identity", "InitializationMethod", "LayerNorm", "Linear",
    "LogSoftMax", "LookupTable", "MultiHeadAttention", "RandomNormal",
    "RandomUniform", "Sequential", "TensorModule", "TimeDistributed",
    "Xavier", "assign_cache_slot", "greedy_generate",
    "install_decode_cache", "reset_decode_slot",
]
