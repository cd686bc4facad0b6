"""Layers of the port (PyTorch), named as in ``bigdl_tpu.nn``."""

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.activation import GELU, LogSoftMax, Swish
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, rope_rotate
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch, greedy_decode
from bigdl_tpu_torch.nn.containers import (
    CAddTable, CMulTable, ConcatTable, Identity, Remat, Sequential,
)
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.fused_loss import (
    ChunkedSoftmaxCrossEntropy, FusedLMHead, chunked_softmax_xent,
)
from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, beam_generate, generate, greedy_generate,
    install_decode_cache, reset_decode_slot, zero_decode_cache,
)
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomNormal, RandomUniform, Xavier,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import Dropout, LayerNorm, RMSNorm
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.nn.recurrent import TimeDistributed

__all__ = [
    "AbstractCriterion", "AbstractModule", "CAddTable", "CMulTable",
    "ChunkedSoftmaxCrossEntropy", "ClassNLLCriterion", "ConcatTable",
    "Container", "CrossEntropyCriterion", "Dropout", "FusedLMHead", "GELU",
    "Identity", "InitializationMethod", "LayerNorm", "Linear",
    "LogSoftMax", "LookupTable", "MultiHeadAttention", "RMSNorm",
    "RandomNormal", "RandomUniform", "Remat", "SequenceBeamSearch",
    "Sequential", "Swish", "TensorModule", "TimeDistributed",
    "TimeDistributedCriterion", "Xavier", "assign_cache_slot",
    "beam_generate", "cast_floating", "chunked_softmax_xent",
    "generate", "greedy_decode", "greedy_generate",
    "install_decode_cache", "reset_decode_slot", "rope_rotate",
    "zero_decode_cache",
]
