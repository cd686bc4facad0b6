"""Layers of the port (PyTorch), named as in ``bigdl_tpu.nn``."""

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.activation import GELU, LogSoftMax, ReLU, Swish, Tanh
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, rope_rotate
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch, greedy_decode
from bigdl_tpu_torch.nn.containers import (
    CAddTable, CMulTable, ConcatTable, Identity, Remat, Sequential,
)
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.convolution import SpatialConvolution
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.fused_loss import (
    ChunkedSoftmaxCrossEntropy, FusedLMHead, chunked_softmax_xent,
)
from bigdl_tpu_torch.nn.graph import fuse_conv_bn
from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, beam_generate, generate, greedy_generate,
    install_decode_cache, reset_decode_slot, zero_decode_cache,
)
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, MsraFiller, Ones, RandomNormal, RandomUniform,
    Xavier, Zeros,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.misc import ImageNormalize
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, Dropout, LayerNorm, RMSNorm, SpatialBatchNormalization,
)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.nn.shape_ops import Reshape, View

__all__ = [
    "AbstractCriterion", "AbstractModule", "BatchNormalization", "CAddTable",
    "CMulTable", "ChunkedSoftmaxCrossEntropy", "ClassNLLCriterion",
    "ConcatTable", "Container", "CrossEntropyCriterion", "Dropout",
    "FusedLMHead", "GELU", "Identity", "ImageNormalize",
    "InitializationMethod", "LayerNorm", "Linear", "LogSoftMax",
    "LookupTable", "MsraFiller", "MultiHeadAttention", "Ones", "RMSNorm",
    "RandomNormal", "RandomUniform", "ReLU", "Remat", "Reshape",
    "SequenceBeamSearch", "Sequential", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialConvolution", "SpatialMaxPooling",
    "Swish", "Tanh", "TensorModule", "TimeDistributed",
    "TimeDistributedCriterion", "View", "Xavier", "Zeros",
    "assign_cache_slot", "beam_generate", "cast_floating",
    "chunked_softmax_xent", "fuse_conv_bn", "generate", "greedy_decode",
    "greedy_generate", "install_decode_cache", "reset_decode_slot",
    "rope_rotate", "zero_decode_cache",
]
