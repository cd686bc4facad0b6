"""Layers of the port (PyTorch), named as in ``bigdl_tpu.nn``."""

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.activation import (
    ELU, GELU, Abs, AddConstant, BinaryThreshold, Clamp, Exp, HardSigmoid,
    HardTanh, LeakyReLU, Log, LogSigmoid, LogSoftMax, MulConstant, Power,
    PReLU, ReLU, ReLU6, Sigmoid, SoftMax, SoftMin, SoftPlus, SoftSign, Sqrt,
    Square, SReLU, Swish, Tanh, TanhShrink,
)
from bigdl_tpu_torch.nn.attention import (
    CrossAttention, MultiHeadAttention, rope_rotate,
)
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch, greedy_decode
from bigdl_tpu_torch.nn.containers import (
    BifurcateSplitTable, Bottle, CAddTable, CAveTable, CDivTable, CMaxTable,
    CMinTable, CMulTable, Concat, ConcatTable, CSubTable, Echo, FlattenTable,
    Identity, JoinTable, MapTable, MaskedSelect, MixtureTable, NarrowTable,
    Pack, ParallelTable, Remat, SelectTable, Sequential,
)
from bigdl_tpu_torch.nn.convolution import (
    LocallyConnected1D, LocallyConnected2D, SpatialConvolution,
    SpatialConvolutionMap, SpatialDilatedConvolution, SpatialFullConvolution,
    SpatialSeparableConvolution, SpatialShareConvolution, TemporalConvolution,
)
from bigdl_tpu_torch.nn.cosine import Cosine, CosineDistance
from bigdl_tpu_torch.nn.detection import (
    Anchor, DetectionOutputSSD, NormalizeScale, PriorBox, Proposal,
    decode_rcnn, decode_ssd, encode_ssd, nms_mask, pairwise_iou,
)
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, AbstractCriterion, BCECriterion, BCECriterionWithLogits,
    CategoricalCrossEntropy, ClassNLLCriterion, ClassSimplexCriterion,
    CosineDistanceCriterion, CosineEmbeddingCriterion,
    CosineProximityCriterion, CrossEntropyCriterion, DiceCoefficientCriterion,
    DistKLDivCriterion, GaussianCriterion, HingeEmbeddingCriterion,
    KLDCriterion, KullbackLeiblerDivergenceCriterion, L1Cost,
    L1HingeEmbeddingCriterion, MarginCriterion, MarginRankingCriterion,
    MeanAbsolutePercentageCriterion, MeanSquaredLogarithmicCriterion,
    MSECriterion, MultiCriterion, MultiLabelMarginCriterion,
    MultiLabelSoftMarginCriterion, MultiMarginCriterion, ParallelCriterion,
    PoissonCriterion, SmoothL1Criterion, SmoothL1CriterionWithWeights,
    SoftMarginCriterion, SoftmaxWithCriterion, TimeDistributedCriterion,
    TimeDistributedMaskCriterion, TransformerCriterion,
)
from bigdl_tpu_torch.nn.embedding import HashBucketEmbedding, LookupTable
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
    BilinearFiller, ConstInitMethod, InitializationMethod, MsraFiller, Ones,
    RandomNormal, RandomUniform, Xavier, Zeros,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.lora import LoRALinear, apply_lora, merge_lora
from bigdl_tpu_torch.nn.maskrcnn import (
    FPN, BoxHead, DetectionOutputFrcnn, MaskHead, Pooler, RegionProposal,
    RoiAlign,
)
from bigdl_tpu_torch.nn.misc import (
    MM, MV, ActivityRegularization, Bilinear, Cropping2D, Cropping3D,
    CrossProduct, DotProduct, Euclidean, GaussianSampler, GradientReversal,
    HardShrink, Highway, ImageNormalize, L1Penalty, Max, Maxout, Mean, Min,
    Negative, NegativeEntropyPenalty, PairwiseDistance, ResizeBilinear, RReLU,
    Scale, SoftShrink, SpatialUpSamplingBilinear, SpatialUpSamplingNearest,
    Sum, Threshold, UpSampling1D, UpSampling2D, UpSampling3D,
)
from bigdl_tpu_torch.nn.multibox import MultiBoxCriterion, match_priors
from bigdl_tpu_torch.nn.normalization import (
    Add, BatchNormalization, CAdd, CMul, Dropout, GaussianDropout,
    GaussianNoise, LayerNorm, Mul, Normalize, RMSNorm,
    SpatialBatchNormalization, SpatialContrastiveNormalization,
    SpatialCrossMapLRN, SpatialDivisiveNormalization, SpatialDropout1D,
    SpatialDropout2D, SpatialDropout3D, SpatialSubtractiveNormalization,
    SpatialWithinChannelLRN,
)
from bigdl_tpu_torch.nn.pooling import (
    SpatialAveragePooling, SpatialMaxPooling, TemporalAveragePooling,
    TemporalMaxPooling,
)
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.nn.quantized import (
    QuantizedLinear, QuantizedSpatialConvolution,
    QuantizedSpatialDilatedConvolution, calibrate, quantize_module,
)
from bigdl_tpu_torch.nn.recurrent import (
    GRU, LSTM, BiRecurrent, Cell, ConvLSTMPeephole, ConvLSTMPeephole3D,
    LSTMPeephole, Masking, MultiRNNCell, Recurrent, RecurrentDecoder,
    RnnCell, TimeDistributed,
)
from bigdl_tpu_torch.nn.roi import RoiPooling
from bigdl_tpu_torch.nn.shape_ops import (
    Contiguous, Flatten, Index, InferReshape, Narrow, Padding, Replicate,
    Reshape, Reverse, Select, SpatialZeroPadding, SplitTable, Squeeze, Tile,
    Transpose, Unsqueeze, View,
)
from bigdl_tpu_torch.nn.sparse import (
    DenseToSparse, LookupTableSparse, SparseEmbeddingSum, SparseJoinTable,
    SparseLinear,
)
from bigdl_tpu_torch.nn.tf_utils import (
    Const, Fill, Shape, SplitAndSelect, StrideSlice,
)
from bigdl_tpu_torch.nn.transformer_layers import (
    Attention, ExpandSize, FeedForwardNetwork, LayerNormalization,
    TableOperation, Transformer,
)
from bigdl_tpu_torch.nn.tree import BinaryTreeLSTM
from bigdl_tpu_torch.nn.volumetric import (
    VolumetricAveragePooling, VolumetricConvolution, VolumetricFullConvolution,
    VolumetricMaxPooling,
)

# every class imported above, and these functions
__all__ = sorted([name for name, value in dict(globals()).items()
                  if isinstance(value, type)] + [
    "apply_lora", "assign_cache_slot", "beam_generate", "calibrate",
    "cast_floating", "chunked_softmax_xent", "decode_rcnn", "decode_ssd",
    "encode_ssd", "fuse_conv_bn", "generate", "greedy_decode",
    "greedy_generate", "install_decode_cache", "make_node", "match_priors",
    "merge_lora", "nms_mask", "pairwise_iou", "quantize_module",
    "reset_decode_slot", "restart_decode_cache", "rope_rotate"])
