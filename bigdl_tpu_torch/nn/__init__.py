"""Layers of the port (PyTorch), named as in ``bigdl_tpu.nn``."""

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.activation import GELU, LogSoftMax, ReLU, Swish, Tanh
from bigdl_tpu_torch.nn.attention import (
    CrossAttention, MultiHeadAttention, rope_rotate,
)
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch, greedy_decode
from bigdl_tpu_torch.nn.containers import (
    CAddTable, CMulTable, Concat, ConcatTable, Identity, JoinTable, Remat,
    SelectTable, Sequential,
)
from bigdl_tpu_torch.nn.criterion import (
    AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
    ParallelCriterion, TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.convolution import (
    SpatialConvolution, TemporalConvolution,
)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.fused_loss import (
    ChunkedSoftmaxCrossEntropy, FusedLMHead, chunked_softmax_xent,
)
from bigdl_tpu_torch.nn.graph import (
    Graph, Input, ModuleNode, StaticGraph, fuse_conv_bn, make_node,
)
from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, beam_generate, generate, greedy_generate,
    install_decode_cache, reset_decode_slot, restart_decode_cache,
)
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, MsraFiller, Ones, RandomNormal, RandomUniform,
    Xavier, Zeros,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.lora import LoRALinear, apply_lora, merge_lora
from bigdl_tpu_torch.nn.misc import ImageNormalize
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, Dropout, LayerNorm, RMSNorm, SpatialBatchNormalization,
    SpatialCrossMapLRN,
)
from bigdl_tpu_torch.nn.pooling import (
    SpatialAveragePooling, SpatialMaxPooling, TemporalMaxPooling,
)
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.nn.recurrent import (
    GRU, LSTM, BiRecurrent, Cell, ConvLSTMPeephole, ConvLSTMPeephole3D,
    LSTMPeephole, Masking, MultiRNNCell, Recurrent, RecurrentDecoder,
    RnnCell, TimeDistributed,
)
from bigdl_tpu_torch.nn.shape_ops import Reshape, Select, Squeeze, View
from bigdl_tpu_torch.nn.transformer_layers import (
    Attention, ExpandSize, FeedForwardNetwork, LayerNormalization,
    TableOperation, Transformer,
)
from bigdl_tpu_torch.nn.tree import BinaryTreeLSTM

__all__ = [
    "AbstractCriterion", "AbstractModule", "Attention", "BatchNormalization",
    "BiRecurrent", "BinaryTreeLSTM", "CAddTable", "CMulTable", "Cell",
    "ChunkedSoftmaxCrossEntropy", "ClassNLLCriterion", "Concat", "ConcatTable",
    "Container", "ConvLSTMPeephole", "ConvLSTMPeephole3D", "CrossAttention",
    "CrossEntropyCriterion", "Dropout", "ExpandSize", "FeedForwardNetwork",
    "FusedLMHead", "GELU", "GRU", "Graph", "Identity", "ImageNormalize",
    "InitializationMethod", "Input", "JoinTable", "LSTM", "LSTMPeephole",
    "LayerNorm", "LayerNormalization", "Linear", "LoRALinear", "LogSoftMax",
    "LookupTable", "Masking", "ModuleNode", "MsraFiller", "MultiHeadAttention",
    "MultiRNNCell", "Ones", "ParallelCriterion", "RMSNorm", "RandomNormal",
    "RandomUniform", "ReLU", "Recurrent", "RecurrentDecoder", "Remat",
    "Reshape", "RnnCell", "Select", "SelectTable", "SequenceBeamSearch",
    "Sequential", "SpatialAveragePooling", "SpatialBatchNormalization",
    "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling", "Squeeze",
    "StaticGraph", "Swish", "TableOperation", "Tanh", "TemporalConvolution",
    "TemporalMaxPooling", "TensorModule", "TimeDistributed",
    "TimeDistributedCriterion", "Transformer", "View", "Xavier", "Zeros",
    "apply_lora", "assign_cache_slot", "beam_generate", "cast_floating",
    "chunked_softmax_xent", "fuse_conv_bn", "generate", "greedy_decode",
    "greedy_generate", "install_decode_cache", "make_node", "merge_lora",
    "reset_decode_slot", "restart_decode_cache", "rope_rotate",
]
